"""The plain reference: GoMAvatar's frame, losses and steps in plain PyTorch
and numpy, importing nothing of the program."""

"""The harness's shared parts: inputs from the seed, the run's context and checks, spans and traces, work counts."""

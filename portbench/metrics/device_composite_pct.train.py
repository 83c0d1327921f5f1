"""The share of train items whose composite over their background and
resizes ran on the card (counter ``data.device_composite`` of
``TrainDataset.item``) among all items of its cv2 path (with
``data.host_composite``: the host's float64 composite and cv2 resizes),
counted over the profiled stretch from its first unit on, in %.  None
where neither counter was taken: a program older than them."""

from portbench.lib import program_records as records

CARD, HOST = "data.device_composite", "data.host_composite"


def read(run):
    start = records.units_start(run)
    if start is None:
        return None
    from gomavatar_tpu_torch.utils.profiling import Count, records as kept

    n = {CARD: 0, HOST: 0}
    for r in kept(start, run["t_prof"][1]):
        if isinstance(r, Count) and r.name in n:
            n[r.name] += r.n
    total = n[CARD] + n[HOST]
    return None if total == 0 else 100.0 * n[CARD] / total

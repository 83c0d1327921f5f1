"""The share of train items whose frame's decoded pixels ``TrainDataset``
had kept (counter ``data.decode_cache_hit``) among all items of its cv2
path (with ``data.decode_cache_miss``: read and undistorted anew), counted
over the profiled stretch from its first unit on, in %.  None where neither
counter was taken: a program older than them."""

from portbench.lib import program_records as records

HIT, MISS = "data.decode_cache_hit", "data.decode_cache_miss"


def read(run):
    start = records.units_start(run)
    if start is None:
        return None
    from gomavatar_tpu_torch.utils.profiling import Count, records as kept

    n = {HIT: 0, MISS: 0}
    for r in kept(start, run["t_prof"][1]):
        if isinstance(r, Count) and r.name in n:
            n[r.name] += r.n
    total = n[HIT] + n[MISS]
    return None if total == 0 else 100.0 * n[HIT] / total

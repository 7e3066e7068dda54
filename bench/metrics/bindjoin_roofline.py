"""Kernels: the bind-join kernels' share of their roofline, in percent:
over the launches of the profiled sub-window that have a device record,
the sum of each launch's bound (the larger of its bytes over the HBM
rate and its operations over the INT32 rate, counted by its file under
``bench/roofline/``) over the sum of its device time."""


def read(run):
    p = run.profile
    if p is None:
        return None
    bound = device = 0.0
    for rec in p["launches"]:
        if not rec["kernel"].startswith("bindjoin"):
            continue
        ops, nbytes = run.rooflines[rec["kernel"]].work(rec["facts"])
        bound += max(nbytes / run.peaks["hbm_bytes_per_s"],
                     ops / run.peaks["int32_ops_per_s"])
        device += rec["device_ns"] / 1e9
    return 100.0 * bound / device if device else None

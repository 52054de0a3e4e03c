"""outside_kernels_pct.batch: share of the device's operation time in the
traced span spent outside the two hand-written kernels (the residual-block
kernels, ``resblock_*``, and the whole-net ``mega_kernel``)."""

HAND = ("resblock_", "mega_kernel")


def read(run):
    p = run.profile
    if p is None:
        return None
    total = sum(s for _, s in p.device_ops.values())
    if total == 0:
        return None
    hand = sum(s for name, (_, s) in p.device_ops.items() if any(h in name for h in HAND))
    return 100.0 * (total - hand) / total

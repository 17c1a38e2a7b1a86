"""ops_per_frame.view: device operations (kernels, copies, fills) per
viewer frame in the traced block."""


def read(ctx):
    t = ctx["trace"]
    return len(t.device_ops) / t.iters if t.device_ops else None

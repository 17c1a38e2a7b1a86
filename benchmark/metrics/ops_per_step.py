"""ops_per_step.train: device operations (kernels, copies, fills) per
training step in the traced block."""


def read(ctx):
    t = ctx["trace"]
    return len(t.device_ops) / t.iters if t.device_ops else None

"""Device time of a training step's ATen elementwise, reduction and
``_foreach`` kernels: the model's forward and backward and the Monte-Carlo
loss's as well as the trainer's (the clip's kernels a leaf, fused Adam);
kernel names do not tell them apart."""

from port_bench import readers


def read(ctx):
    return readers.device_ms(ctx, "step", "elementwise")

"""Seconds this process spent in ``ray_tpu_torch.ops.cuda_build.load``,
builds included: the sum over the program's record of each kernel's first
load (name, seconds, whether ``nvcc`` ran).  Silent on a program without
that record."""


def read(run):
    try:
        from ray_tpu_torch.ops.cuda_build import loads
    except ImportError:
        return None
    return sum(rec.seconds for rec in loads)

"""Loss trunk (``models/vgg.py`` -> ``ops/conv_kernels.py``,
``ops/head_kernels.py``, K5-K8, and conv1_1 in ``ops/conv_im2col.py``): the
operations of every trunk convolution in the profiled stretch, forward and
input gradient, with the chunks' content encodes (``work.py``), at the
dense bf16 peak, over the device time of the kernels named below, in
percent. conv1_1 runs on the stem kernels
``stem_conv_gemm_{fwd,bwd}_kernel``, whose names hold ``gemm``."""

KERNELS = ("conv3x3_gemm_kernel", "conv_relu_pool_kernel",
           "conv_relu_pool_bwd_kernel", "gemm")


def read(record):
    if record.peaks is None:
        return None
    s = record.stretches["profiled"]
    ops = 0.0
    for key, steps, prepared in s.segments:
        w = record.session.chunk_work(key)
        ops += steps * w.trunk_step() + prepared * w.trunk_chunk()
    device = s.timeline.device_s(KERNELS)
    if device <= 0 or ops <= 0:
        return None
    return 100.0 * ops / record.peaks["bf16_flop_per_s"] / device

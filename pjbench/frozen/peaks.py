"""Published peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit,
frozen (NVIDIA's data sheet; the same figures as the program's
``observe/roofline.py`` ``PLATFORM_PEAKS`` when this benchmark was
defined)."""

# HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = 3.35e12
# FP32 outside the tensor cores, operations per second (an FMA is two).
FP32_FLOPS_PER_S = 67e12

"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W power limit). The cells run float32 with TF32 off, so a step's
matrix products are held to the float32 rate outside the tensor cores."""
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

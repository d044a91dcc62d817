"""Published peaks of one NVIDIA H100 SXM: the rates that a kernel's least
time (its bound) divides its bytes and its operations by."""

HBM_BYTES_PER_S = 3.35e12   # device memory (NVIDIA data sheet)
# 32-bit integer add, logic, compare and min/max: 64 results per clock per
# SM on compute capability 9.0 (CUDA C++ Programming Guide, throughput of
# native arithmetic instructions), on 132 SMs at the 1,980 MHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9

"""Published peaks of one NVIDIA H100 SXM: the rates that a kernel's least
time (its bound) divides its bytes and its operations by."""

SMS = 132                   # streaming multiprocessors
SM_CLOCK_HZ = 1.98e9        # the boost clock
HBM_BYTES_PER_S = 3.35e12   # device memory (NVIDIA data sheet)
# 32-bit integer add, logic, compare and min/max: the dispatch ceiling, one
# warp instruction a clock on each of an SM's 4 schedulers, 32 lanes each,
# 128 results a clock an SM; no stream of 32-bit instructions issues more.
# The 64 a clock of the CUDA C++ Programming Guide's throughput table is
# not a bound on this card: carry60 of csrc/probes.cu (60 independent +1s
# a column, block policy, G=128, W=128: one row an SM) ran 79.9 to 88.3
# adds a clock an SM on an NVIDIA H100 80GB HBM3 at 700.00 W, SM clock
# 1,980 MHz under load (chip_smoke.py phase 3 and tools/carry_probe.py);
# its adds compile to IADD3 and VIADD, which issue to more than one pipe.
INT32_OPS_PER_S = SMS * 4 * 32 * SM_CLOCK_HZ

"""damapper_tpu_torch — the long-read mapper on PyTorch and CUDA (Hopper).

The same pipeline as the JAX package beside it, ported module by module:

  * data plane      — DAZZ .db/.dam/.las codecs (io)
  * k-mer index     — host extraction + sort (ops.kmers, native C++)
  * seed matching   — sort-merge intersection with the -M governor (ops.seeds)
  * chaining        — sweep chain DP (ops.chain, native C++)
  * wave alignment  — O(nd) trace-point wave: host oracle (ops.wave) and the
                      batched lane kernel, CUDA for sm_90a (ops.wave_cuda,
                      csrc/wave.cu), driven by ops.wave_engine
  * reporting       — LA fusion/chain-graph/zone selection + .las emission
                      (pipeline.reporter, pipeline.mapper)
  * DAZZ tool chain — lasort/lacat/lamerge/lacheck/dbsplit/dbshow/fasta2*
                      (cli), lashow with exact traces and gap consolidation
                      (io.display, ops.trace, ops.gap), the QV codec (io.qv)
  * cluster plans   — HPC.damapper plans (parallel.plan) and their runner
                      over torch.distributed ranks (parallel.launch)

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

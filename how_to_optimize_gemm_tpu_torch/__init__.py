"""PyTorch/CUDA port of the GEMM ladder for one NVIDIA H100.

The TPU package ``how_to_optimize_gemm_tpu`` stays the reference; this
package mirrors its layout (``ops/``, ``utils/``, ``harness/``,
``models/``, ``parallel/``) and its public names, so each module has an
obvious counterpart there. It imports torch and numpy only. Every
Pallas kernel on the ported path is a hand-written Hopper kernel under
``csrc/`` (built with nvcc at first use, bound with ctypes, see
``_build.py``); each kernel's wrapper keeps a plain PyTorch version
beside it that runs only for tensors on the CPU.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

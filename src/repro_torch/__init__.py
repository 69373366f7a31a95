"""PyTorch/CUDA port of the JAX package ``repro``, for one NVIDIA H100.

Mirrors ``src/repro/``'s layout and names module for module.  It imports
torch and numpy only — never JAX, and nothing of ``repro``.  Ported so
far: paged serving of dense decoders (``serving.ContinuousBatcher`` with
``cache_layout="paged"``), with paged attention in a hand-written CUDA
kernel (``kernels/paged_attention``); and the paper's learning framework
(``core.experiment.run_scenario``: Cloud, GTL, noHTL), with GreedyTL's
Gram statistic and candidate scoring in hand-written CUDA kernels
(``kernels/greedy_scores``); and the no-cache prefill of the dense,
hybrid and RWKV6 families (``serving.serve_step.make_prefill_step``),
with flash attention and the chunked GLA scan in hand-written CUDA
kernels (``kernels/flash_attention``, ``kernels/ssm_scan``).  Entry
points take ``device=`` and default to ``"cuda"``; the CPU runs only
when the caller asks for it.
"""

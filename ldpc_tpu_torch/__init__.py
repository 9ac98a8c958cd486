"""ldpc_tpu_torch: the PyTorch/CUDA port of ``ldpc_tpu`` for one NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``ldpc_tpu``;
sub-packages mirror ``ldpc_tpu`` so each module's counterpart is easy to
find:

  codes/   QC shift tables, the JSON code format and the reference's file
           formats, the observation codec, CCSDS near-earth and its
           generator, the IEEE 802.11n n = 1944 family, synthetic QC codes,
           the zeroed-circulant suite, the systematic encoder
  ops/     decode plans; the fused decode kernel (``csrc/decode.cu``), its
           plain PyTorch versions and wrapper (``ops/cuda_static.py``); the
           phase-split pair (``csrc/split.cu``, ``ops/cuda_split.py``); the
           plain-torch decoder of the ``"torch"`` engine
           (``ops/decoder.py``); the dynamic-plan decoder
           (``ops/dynamic.py``); the f64 oracle
  sim/     BPSK/AWGN channel, Monte-Carlo sweeps (``evaluate_code``, the
           staged cascade, ``sort_words``, random codewords, the
           host-staged ``staged_decode_counts``), BER/FER statistics, the
           code-search reward
  envs/    the code-search env (``LdpcCodeSearchEnv``: each candidate
           decoded by the fused kernel on the card, by ``ops/dynamic.py``
           on the CPU) and its vector container
  rl/      the autoregressive actor-critic, the GAE buffer, PPO (vector
           rollout, exact resume) and VPG, the trainer's entry point, the
           random-search baseline; the continuous-control suite (DDPG/TD3,
           SAC, TRPO, their networks, replay buffer and point-mass env)
  models/  the networks of ``rl/`` under the conventional name
  utils/   device selection, the bounded cache, the experiment loggers,
           checkpoints (``torch.save``), experiment grids, artifact
           provenance
  parallel/ ``torch.distributed`` meshes, the sharded sweeps (the
           cascade per rank, the counters summed with ``all_reduce``) and
           the row-sharded decoder
  native/  the C++ min-sum host engine (g++ + ctypes)
  analysis/ evaluation plots, the experiment post-mortem (best codes,
           top-K re-evaluated selection, action heat maps, the reward
           surface), the live dashboards
  csrc/    CUDA sources and their nvcc + ctypes build
  scripts/ ``python -m ldpc_tpu_torch.scripts.<name>``: the A/Bs, the
           microbenchmark, the SASS counts, the validation studies, the
           kernel studies (layered_ab, quantized_ber, sched_ab,
           perturbation_fer)
  cli.py   ``python -m ldpc_tpu_torch.cli evaluate|bench|probe|random-agent|
           perturb|train|getting-started|post-mortem|reward-surface``
  dryrun.py ``entry()`` and ``dryrun_multichip(n)``: the flagship step and
           the multi-rank dry run

Entry points run on the card unless called with ``device="cpu"``.

Quick start (on the card)::

    import torch
    from ldpc_tpu_torch.codes import near_earth_code
    from ldpc_tpu_torch.sim import make_staged_sweep_device
    step = make_staged_sweep_device(
        near_earth_code(), 50, engine="cuda",
        generator=torch.Generator("cuda").manual_seed(0))
    out = step(torch.full((32768,), 3.4))
"""

__version__ = "0.2.0"

__all__ = ["codes", "ops", "sim", "envs", "rl", "models", "utils",
           "native", "analysis", "csrc", "scripts", "parallel"]

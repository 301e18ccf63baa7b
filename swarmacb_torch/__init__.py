"""swarmacb_torch — the PyTorch / CUDA port of swarmacb_tpu.

The JAX package (``swarmacb_tpu``) stays the reference; this package does
the same work in PyTorch and runs on an NVIDIA H100. It imports nothing of
JAX or of the JAX package. Entry points (``DirectionalGateEnv``) run on the
card unless the caller passes ``device="cpu"``; they never fall back to the
CPU on their own.

Package layout (mirrors swarmacb_tpu)
─────────────────────────────────────
  config/    env + trainer configs, ML-Agents-schema YAML loader (copies)
  env/       batched Directional Gate env: geometry, physics, sensors
  models/    actor and attention-based POCA critic (nn.Modules)
  agents/    rollout container, λ-returns, losses, the POCA trainer (one
             device, or a rank of a data-parallel run), the seed-parallel
             trainer and their checkpoints
  parallel/  data-parallel ranks over torch.distributed (NCCL on the card,
             gloo on the CPU): make_mesh, the draw rule, the all-reduce
  ops/       hand-written CUDA kernels (csrc/) with their plain versions
  utils/     the summary writer (TensorBoard, else JSONL)
  convert    flax params → state_dicts
"""

__version__ = "0.1.0"

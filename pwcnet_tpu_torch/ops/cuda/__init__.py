"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- ``cost_volume.cost_volume_cuda``: K2, the 81-tap correlation;
- ``warped_cv.warped_cost_volume``: K1, bilinear warp + correlation;
- ``pyramid_conv.pyramid_level_fused``: K3, one 3-conv pyramid level;
- ``cost_volume.cost_volume_bwd``: K4, the correlation's backward;
- ``warped_cv.warp_bwd``: K5, the bilinear warp's backward;
- ``pyramid_conv.pyramid_level_bwd``: K6, the pyramid level's backward;
- ``estimator_conv.estimator_chain_fused``: K7, the estimator's six-conv
  chain, and ``estimator_conv.estimator_chain_bwd``, its backward (K7b in
  the launch counts);
- ``cost_volume.cost_volume_hpad_cuda``: K8, a row shard's cost volume
  against halo-extended f1, and ``cost_volume.cost_volume_hpad_bwd`` (K8b);
- ``warped_cv.warped_cost_volume_global``: K9, a row shard's warp + cost
  volume against the whole frame, and ``warped_cv.warped_rows_bwd`` (K9b,
  the tall-frame warp backward that follows K8b in K9's backward);
- ``corr_lookup.corr_lookup_cuda``: R1, RAFT's correlation lookup (no TPU
  kernel: the JAX package has no RAFT), forward only;
- ``raft_update.conv_epilogue_cuda``: R2, the bias and activation after
  each conv of RAFT's update, into channel slots, and the coordinates'
  update (``coords_update_cuda``, counted with it), forward only;
- ``raft_update.gru_gate_zr_cuda``: R3, the GRU's gates (with
  ``gru_gate_h_cuda``, counted with it), forward only;
- ``global_attention.global_attention_cuda``: R4, GMFlow's global matching
  and propagation, ``softmax(q k^T / sqrt(128)) v`` with bf16 q, k and a
  float32 2-column v (no TPU kernel: the JAX package has no GMFlow),
  forward only;
- ``global_attention.attention_softmax_cuda``: R5, GMA's attention softmax,
  float32 score rows to bf16 probabilities, forward only;
- ``raft_update.aggregate_epilogue_cuda``: R6, GMA's ``mf + gamma agg``
  into the update's global slots, forward only.

K1-K3, K7, K8 and K9 are ``torch.autograd.Function``s on CUDA tensors, with
K4-K6, K7b, K8b and K9b as their backward. Each wrapper sends a CPU tensor to its plain PyTorch
version and a CUDA tensor to its kernel (or raises): nothing falls back.
R1-R6's wrappers take CUDA tensors only; ``ops.corr_lookup.lookup``, the
ops of ``ops.raft_update``, and ``ops.attention.global_attention`` and
``global_softmax`` send CPU tensors to their plain versions. Each keeps a
count of the calls in which it launched its kernel in ``<wrapper>.launches``.
"""

from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts", "wrappers"]


def wrappers() -> dict:
    """Kernel id -> wrapper function."""
    from pwcnet_tpu_torch.ops.cuda.corr_lookup import corr_lookup_cuda
    from pwcnet_tpu_torch.ops.cuda.cost_volume import (
        cost_volume_bwd, cost_volume_cuda, cost_volume_hpad_bwd, cost_volume_hpad_cuda)
    from pwcnet_tpu_torch.ops.cuda.estimator_conv import estimator_chain_bwd, estimator_chain_fused
    from pwcnet_tpu_torch.ops.cuda.global_attention import attention_softmax_cuda, global_attention_cuda
    from pwcnet_tpu_torch.ops.cuda.pyramid_conv import pyramid_level_bwd, pyramid_level_fused
    from pwcnet_tpu_torch.ops.cuda.raft_update import (
        aggregate_epilogue_cuda, conv_epilogue_cuda, gru_gate_zr_cuda)
    from pwcnet_tpu_torch.ops.cuda.warped_cv import (
        warp_bwd, warped_cost_volume, warped_cost_volume_global, warped_rows_bwd)

    return {
        "K1": warped_cost_volume,
        "K2": cost_volume_cuda,
        "K3": pyramid_level_fused,
        "K4": cost_volume_bwd,
        "K5": warp_bwd,
        "K6": pyramid_level_bwd,
        "K7": estimator_chain_fused,
        "K7b": estimator_chain_bwd,
        "K8": cost_volume_hpad_cuda,
        "K8b": cost_volume_hpad_bwd,
        "K9": warped_cost_volume_global,
        "K9b": warped_rows_bwd,
        "R1": corr_lookup_cuda,
        "R2": conv_epilogue_cuda,
        "R3": gru_gate_zr_cuda,
        "R4": global_attention_cuda,
        "R5": attention_softmax_cuda,
        "R6": aggregate_epilogue_cuda,
    }


def launch_counts() -> dict:
    """Kernel id -> launches since the last reset."""
    return {k: fn.launches for k, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0

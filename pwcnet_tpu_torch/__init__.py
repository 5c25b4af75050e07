"""PWC-Net in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of the JAX package ``pwcnet_tpu``: the same
PWCDCNet serving forward (TF1 resize, SAME padding, warp and cost-volume
semantics), with the JAX package's Pallas TPU kernels rewritten as CUDA
C++ for ``sm_90a`` (``pwcnet_tpu_torch/csrc``). The kernels are compiled
with ``nvcc`` at first use (``ops/cuda/_build.py``); importing this
package builds nothing.

Layout: ops and kernels take NHWC tensors, as the JAX package does; the
models keep logical NCHW tensors in ``torch.channels_last`` memory
format, whose NHWC permutation is contiguous and goes to the kernels
without a copy.
"""

__all__ = ["FlowPredictor", "PWCDCNet"]


def __getattr__(name):
    # lazy: `import pwcnet_tpu_torch` stays cheap and side-effect free
    if name == "FlowPredictor":
        from pwcnet_tpu_torch.inference import FlowPredictor

        return FlowPredictor
    if name == "PWCDCNet":
        from pwcnet_tpu_torch.models.pwcnet import PWCDCNet

        return PWCDCNet
    raise AttributeError(f"module 'pwcnet_tpu_torch' has no attribute {name!r}")

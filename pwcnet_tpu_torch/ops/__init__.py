"""Plain PyTorch ops on NHWC tensors: ``resize``, ``cost_volume``, ``warp``.

The CUDA kernels and their wrappers live in ``ops.cuda``. Import the
functions from their modules (``from pwcnet_tpu_torch.ops.warp import
bilinear_warp``): this package re-exports nothing, so no function shadows
the submodule of the same name.
"""

"""R4, GMFlow's global matching and propagation as one CUDA kernel
(``ops.cuda.global_attention.global_attention_cuda``, ``csrc/global_attention.cu``).

On the CPU: the wrapper's refusals, which all run before the launch, and
``ops.attention.global_attention`` taking its plain route on CPU tensors.
On the card (``-m cuda``): the kernel against a float64 softmax product at
the GMFlow cell's 7168 keys (a 1/8 grid of 448x1024 frames) with the pixel
grid as the value (expanded: batch stride 0) and with a signed flow-like
value, held to 4e-6 of the output's largest magnitude and to twice the
error of PyTorch's float32 memory-efficient attention on the same inputs
(a yardstick inside the test only: the port never calls it); ragged N and
B = 1; one launch a call.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.models.gmflow import coords_grid
from pwcnet_tpu_torch.ops import attention
from pwcnet_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from pwcnet_tpu_torch.ops.cuda.global_attention import global_attention_cuda

CELL_GRID = (56, 128)  # the GMFlow cell's 1/8 grid: 7168 keys
REL_TOL = 4e-6  # of max |ref|: float32 sums of 7168 terms, a few units of rounding


def _inputs(b, h, w, device, seed, value="grid", spread=1.0):
    """bf16 q, k (b, h w, 128) with scores of standard deviation ``spread``
    and a float32 value: the pixel grid expanded over the batch, or a
    smooth signed flow of up to about 40 px with a mean of (12, -7)."""
    g = torch.Generator().manual_seed(seed)
    n = h * w
    q = (spread * torch.randn(b, n, 128, generator=g)).to(torch.bfloat16)
    k = torch.randn(b, n, 128, generator=g).to(torch.bfloat16)
    grid = coords_grid(h, w, "cpu")
    if value == "grid":
        v = grid.to(device).expand(b, n, 2)
    else:
        phase = torch.rand(b, 1, 2, generator=g) * 2 * math.pi
        waves = torch.sin(2 * math.pi * grid / torch.tensor([w, h]) + phase)
        v = (torch.tensor([12.0, -7.0]) + torch.tensor([25.0, 20.0]) * waves
             + torch.randn(b, n, 2, generator=g)).to(device)
    return q.to(device), k.to(device), v


def _reference(q, k, v):
    """float64 ``softmax(q k^T / sqrt(128)) v``, one batch row at a time."""
    rows = []
    for qi, ki, vi in zip(q.double(), k.double(), v.double()):
        rows.append(torch.softmax(qi @ ki.T / math.sqrt(q.shape[-1]), -1) @ vi)
    return torch.stack(rows)


def _library(q, k, v):
    """The float32 memory-efficient scaled_dot_product_attention on the widened
    q, k and the value padded to 8 columns, as the port ran it before R4."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q.float()[:, None], k.float()[:, None],
                                             F.pad(v.float(), (0, 6))[:, None], scale=1 / math.sqrt(q.shape[-1]))
    return out[:, 0, :, :2]


@pytest.mark.parametrize("fault", ["float32_q", "float32_k", "float64_v", "channels", "value_columns", "keys",
                                   "grad", "strided_q", "strided_k", "misaligned_q", "misaligned_v", "cpu"])
def test_r4_refuses_what_it_does_not_take(fault):
    """bf16 q and k of 128 channels, contiguous and 16-byte aligned; a
    float32 value of 2 columns, 8-byte aligned; no grad; CUDA tensors.
    Nothing launches."""
    q, k, v = _inputs(2, 4, 6, "cpu", seed=0)
    want = (ValueError, "CUDA device")
    if fault == "float32_q":
        q, want = q.float(), (TypeError, "bfloat16")
    elif fault == "float32_k":
        k, want = k.float(), (TypeError, "bfloat16")
    elif fault == "float64_v":
        v, want = v.double(), (TypeError, "v float32")
    elif fault == "channels":
        q, k, want = q[..., :64], k[..., :64], (ValueError, r"\(B, N, 128\)")
    elif fault == "value_columns":
        v, want = torch.cat([v, v[..., :1]], -1), (ValueError, r"v must be \(2, 24, 2\)")
    elif fault == "keys":
        k, want = k[:, :-1], (ValueError, r"\(B, N, 128\)")
    elif fault == "grad":
        q, want = q.requires_grad_(True), (RuntimeError, "no backward")
    elif fault == "strided_q":
        q, want = q.transpose(0, 1).contiguous().transpose(0, 1), (ValueError, "contiguous")
    elif fault == "strided_k":
        k, want = torch.cat([k, k], -1)[..., ::2], (ValueError, "contiguous")
    elif fault == "misaligned_q":
        q, want = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape), (ValueError, "16-byte aligned")
    elif fault == "misaligned_v":
        v, want = torch.cat([v.new_zeros(1), v.flatten()])[1:].view(v.shape), (ValueError, "8-byte aligned")
    before = global_attention_cuda.launches
    with pytest.raises(want[0], match=want[1]):
        global_attention_cuda(q, k, v)
    assert global_attention_cuda.launches == before


@pytest.mark.parametrize("value", ["grid", "flow"])
def test_cpu_tensors_take_the_plain_route(value):
    """On CPU tensors ``global_attention`` is the plain product, counted as
    plain; R4 does not launch."""
    q, k, v = _inputs(2, 4, 6, "cpu", seed=1, value=value)
    attention.reset_attention_counts()
    before = global_attention_cuda.launches
    got = attention.global_attention(q, k, v)
    assert attention.attention_counts() == {"window": 0, "global": 0, "scores": 0, "aggregate": 0, "plain": 1}
    assert global_attention_cuda.launches == before
    assert torch.equal(got, attention._plain(q, k, v, None, 1 / math.sqrt(128), torch.float32))
    assert float((got - _reference(q, k, v)).abs().max()) < 1e-4


# ---------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (R4 is a CUDA kernel with no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("value", ["grid", "flow"])
@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_r4_matches_a_float64_product_at_the_cells_keys(cuda_device, value, spread):
    """B=2 at 7168 keys, scores of standard deviation 1 (a flat softmax) and
    4 (a peaked one): within 4e-6 of max |ref| of the float64 product, and
    no worse than twice the float32 memory-efficient call's error."""
    q, k, v = _inputs(2, *CELL_GRID, cuda_device, seed=int(4 * spread) + (value == "flow"), value=value,
                      spread=spread)
    reset_launch_counts()
    with torch.inference_mode():
        got = attention.global_attention(q, k, v)
        lib = _library(q, k, v)
    ref = _reference(q, k, v)
    assert launch_counts()["R4"] == 1
    assert got.dtype == torch.float32 and got.shape == v.shape
    err, lib_err = float((got - ref).abs().max()), float((lib - ref).abs().max())
    assert err <= REL_TOL * float(ref.abs().max()), (err, float(ref.abs().max()))
    assert err <= 2 * lib_err, (err, lib_err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 54, 126), (3, 1, 1), (2, 1, 127), (2, 3, 43), (1, 17, 31)])
@pytest.mark.parametrize("value", ["grid", "flow"])
def test_r4_takes_any_n_and_batch(cuda_device, b, h, w, value):
    """Ragged N (6804 = 54 x 126, 1, 127, 129, 527) and B = 1: keys past N
    score nothing and rows past N are not written."""
    q, k, v = _inputs(b, h, w, cuda_device, seed=h * w, value=value, spread=2.0)
    with torch.inference_mode():
        got = global_attention_cuda(q, k, v)
    ref = _reference(q, k, v)
    assert float((got - ref).abs().max()) <= REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_r4_launches_once_a_call_and_refuses_grad(cuda_device):
    q, k, v = _inputs(2, *CELL_GRID, cuda_device, seed=5)
    reset_launch_counts()
    attention.reset_attention_counts()
    with torch.no_grad():
        attention.global_attention(q, k, v)
        attention.global_attention(q, k, v.contiguous())
    assert {kid: c for kid, c in launch_counts().items() if c} == {"R4": 2}
    assert attention.attention_counts() == {"window": 0, "global": 2, "scores": 0, "aggregate": 0, "plain": 0}
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.global_attention(q, k, v)
    assert launch_counts()["R4"] == 2

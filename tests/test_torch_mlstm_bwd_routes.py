"""The mLSTM backward's two routes, pinned without a card.

``mlstm_scan.bwd_passes`` names the kernels one backward launch runs and
``mlstm_scan.bwd_scratch_shapes`` the scratch the wrapper allocates for
it; both are pure functions of (B·H, L, hd, dtype), so their grid is
checked here, on the CPU.  bf16 q, k, v at hd a multiple of 64 take the
tensor-core route (five passes, bf16 hi/lo planes padded to L rounded up
to 16, one column tile of 64 a state block); everything else the CUDA-core
route (four passes, fp32 L x L scratch, tiles of 32 or of hd).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import mlstm_scan

TC = ("mlstm_bwd_rows_tc_kernel", "mlstm_bwd_state_tc_kernel",
      "mlstm_bwd_dv_tc_kernel", "mlstm_bwd_dcin_tc_kernel",
      "mlstm_bwd_gates_kernel")
CC = ("mlstm_bwd_rows_kernel", "mlstm_bwd_state_kernel",
      "mlstm_bwd_dv_kernel", "mlstm_bwd_gates_kernel")
F32, B16 = torch.float32, torch.bfloat16
BH = 3
SOURCE = (Path(mlstm_scan.__file__).parent / "csrc" / "mlstm_chunk_bwd.cu")


def _padded(l: int) -> int:
    return {1: 16, 16: 16, 17: 32, 256: 256}[l]


@pytest.mark.parametrize("dtype", [F32, B16])
@pytest.mark.parametrize("hd", [8, 16, 64, 1024])
@pytest.mark.parametrize("l", [1, 16, 17, 256])
def test_bwd_route_and_scratch(l, hd, dtype):
    """The passes and the scratch of every (L, hd, dtype) of the grid."""
    tc = dtype == B16 and hd in (64, 1024)
    assert mlstm_scan.bwd_passes(l, hd, dtype) == (TC if tc else CC)
    got = mlstm_scan.bwd_scratch_shapes(BH, l, hd, dtype)
    lp = _padded(l)
    row_blocks = {1: 1, 16: 1, 17: 1, 256: 8}[l]
    tiles = {8: 1, 16: 1, 64: 1 if tc else 2, 1024: 16 if tc else 32}[hd]
    want = {"dS": None if tc else ((BH, l, l), F32),
            "Wm": None if tc else ((BH, l, l), F32),
            "rows": ((BH, 5, l), F32), "w_in": ((BH,), F32),
            "colpart": ((BH, row_blocks, l), F32),
            "epart": ((BH, tiles, l + 1), F32),
            "sw": ((BH, 4, lp, lp), B16) if tc else None,
            "rr": ((BH, 4, lp, hd), B16) if tc else None}
    assert got == want


def test_bwd_passes_lists_both_routes_once():
    """``BWD_PASSES`` holds every kernel of both routes, each once, and
    each route's gates pass last."""
    assert mlstm_scan.BWD_TC == TC and mlstm_scan.BWD_CC == CC
    assert sorted(mlstm_scan.BWD_PASSES) == sorted(set(TC + CC))
    assert len(set(mlstm_scan.BWD_PASSES)) == len(mlstm_scan.BWD_PASSES)
    # no kernel name is a substring of another (the profiler is read by
    # substring)
    for a in mlstm_scan.BWD_PASSES:
        assert [b for b in mlstm_scan.BWD_PASSES if a in b] == [a]


def test_xlstm_train_chunk_scratch_bytes():
    """xlstm-1.3b's train chunk (B·H 16, L 256, hd 1024) in bf16: the
    planes take as many bytes as the fp32 route's dS, W and an fp32 copy
    of r and ri would."""
    got = mlstm_scan.bwd_scratch_shapes(16, 256, 1024, B16)
    assert got["sw"] == ((16, 4, 256, 256), B16)
    assert got["rr"] == ((16, 4, 256, 1024), B16)
    assert got["epart"] == ((16, 16, 257), F32)
    nbytes = sum(torch.Size(shape).numel() * torch.empty(0, dtype=dt)
                 .element_size() for shape, dt in
                 (v for v in got.values() if v is not None))
    assert nbytes == (16 * 2 * 256 * 256 * 4 + 16 * 2 * 256 * 1024 * 4
                      + 4 * (16 * 5 * 256 + 16 + 16 * 8 * 256
                             + 16 * 16 * 257))


def test_scratch_order_matches_the_c_entry():
    """The wrapper passes the scratch in ``bwd_scratch_shapes``' order:
    the C entry's pointer parameters after dn_in, and the entry's count of
    pointers is the wrapper's ``argtypes``."""
    src = SOURCE.read_text()
    sig = re.search(r"int repro_mlstm_chunk_bwd\((.*?)\)\s*\{", src,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    pointers = [p for p, decl in zip(params, sig.split(","))
                if "void*" in decl]
    scratch = pointers[pointers.index("dn_in") + 1:-1]      # stream last
    assert scratch == list(mlstm_scan.bwd_scratch_shapes(1, 1, 8, F32))
    assert len(pointers) - 1 == 27      # the wrapper's c_void_p count


@pytest.mark.parametrize("l", [1, 17, 256])
def test_cpu_backward_takes_no_card(l):
    """On CPU tensors ``MLSTMChunkFn`` runs the plain backward whatever the
    route the card would take: bf16 at hd 64 gives finite gradients of the
    leaves' dtypes and shapes."""
    gen = torch.Generator().manual_seed(l)
    hd = 64
    q, k, v = (torch.randn(2, l, hd, generator=gen).to(B16)
               for _ in range(3))
    i_raw, f_raw = (torch.randn(2, l, generator=gen) for _ in range(2))
    c_in = torch.randn(2, hd, hd, generator=gen)
    n_in = torch.randn(2, hd, generator=gen)
    m_in = torch.randn(2, generator=gen)
    leaves = [t.clone().requires_grad_(True)
              for t in (q, k, v, i_raw, f_raw, c_in, n_in)]
    before = mlstm_scan.BWD_LAUNCHES
    h, c_out, n_out, m_out = mlstm_scan.MLSTMChunkFn.apply(*leaves, m_in)
    grads = torch.autograd.grad((h.sum() + c_out.sum() + n_out.sum()),
                                leaves)
    assert mlstm_scan.BWD_LAUNCHES == before
    assert not m_out.requires_grad
    for g, t in zip(grads, leaves):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g.float()).all()

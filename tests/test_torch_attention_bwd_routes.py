"""The prefill-attention backward's routes, pinned without a card.

``flash_attention.bwd_passes`` names the kernels one backward launch
runs, ``bwd_splits`` over how many blocks the wgmma dK/dV pass splits the
query heads of a KV head, and ``bwd_scratch_shapes`` the scratch the
wrapper allocates for the launch; all are pure functions of the shapes
and dtype, so they are checked here, on the CPU.  bf16 at hd 64 and 128
takes the wgmma route (delta, dK/dV, dQ, and the reduction of the dK/dV
partials where the heads are split); everything else the CUDA-core route.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as fa

F32, B16 = torch.float32, torch.bfloat16
WGMMA = ("bwd_dq_wgmma_kernel", "bwd_dkdv_wgmma_kernel", "bwd_delta_kernel")
REDUCE = "bwd_dkdv_reduce_kernel"
CC = ("bwd_dq_kernel", "bwd_dkdv_kernel", "bwd_delta_kernel")
SOURCE = Path(fa.__file__).parent / "csrc" / "flash_attention_bwd.cu"


@pytest.mark.parametrize("dtype", [F32, B16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("splits", [1, 6])
def test_bwd_passes_by_dtype_and_head_dim(hd, dtype, splits):
    """bf16 at hd 64 and 128 runs the wgmma passes, with the reduction only
    where the heads are split; every other (dtype, hd) the CUDA-core ones."""
    got = fa.bwd_passes(hd, dtype, splits)
    if dtype == B16 and hd >= 64:
        assert got == (WGMMA + (REDUCE,) if splits > 1 else WGMMA)
    else:
        assert got == CC


# (model, B, KVH, Skv, G) -> splits, at the zoo's training shapes
@pytest.mark.parametrize("model,b,kvh,skv,g,want", [
    ("qwen3-0.6b", 4, 8, 2048, 2, 1),
    ("qwen1.5-0.5b", 4, 16, 2048, 1, 1),
    ("jamba / phi3.5-moe", 4, 8, 2048, 4, 1),
    ("chameleon-34b", 4, 8, 2048, 8, 1),
    ("qwen3-moe-30b-a3b", 4, 4, 2048, 8, 2),
    ("granite-34b", 4, 1, 2048, 48, 6),
    ("granite-34b, B 1", 1, 1, 2048, 48, 24),
    ("starcoder2-3b, S 4096", 4, 2, 4096, 12, 2),
    ("whisper-medium encoder", 4, 16, 1500, 1, 1),
    ("whisper-medium decoder, B 2", 2, 16, 448, 1, 1),
])
def test_bwd_splits_at_the_zoo(model, b, kvh, skv, g, want):
    """The heads split only where B·KVH·⌈Skv/128⌉ blocks leave the 132 SMs
    with fewer than two each, into the smallest divisor of G that gives
    them two (G itself when none does, 1 for G 1)."""
    got = fa.bwd_splits(b, kvh, skv, g)
    assert got == want, model
    assert g % got == 0
    blocks = b * kvh * -(-skv // fa.DKDV_KEYS)
    if got > 1:
        assert blocks < 2 * fa.SMS
        assert blocks * got >= 2 * fa.SMS or got == g
        assert all(blocks * d < 2 * fa.SMS for d in range(1, got)
                   if g % d == 0)


@pytest.mark.parametrize("g", [1, 2, 7, 48])
@pytest.mark.parametrize("skv", [1, 128, 129, 2048])
def test_bwd_splits_divides_g(g, skv):
    """Whatever the shape, the split divides G and never exceeds it."""
    for b, kvh in ((1, 1), (4, 1), (4, 8), (64, 8)):
        s = fa.bwd_splits(b, kvh, skv, g)
        assert 1 <= s <= g and g % s == 0


@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,dtype,splits", [
    (4, 16, 8, 2048, 2048, 128, B16, 1),          # qwen3-0.6b
    (4, 48, 1, 2048, 2048, 128, B16, 6),          # granite-34b
    (2, 16, 16, 1000, 1000, 128, B16, 1),         # ragged Sq
    (1, 48, 1, 130, 130, 128, F32, 1),            # CUDA-core: never split
    (1, 48, 1, 130, 130, 32, B16, 1),
    (2, 16, 16, 448, 1500, 64, B16, 1),           # whisper cross
])
def test_bwd_scratch_shapes(b, h, kvh, sq, skv, hd, dtype, splits):
    """rowstats holds lse and D of every (b, head) over Sq rounded up to
    128 rows; the partials exist only where the heads are split, one dK
    and one dV plane of (B·KVH, Skv, hd) a split."""
    got = fa.bwd_scratch_shapes(b, h, kvh, sq, skv, hd, dtype)
    sq_pad = -(-sq // 128) * 128
    assert got["rowstats"] == (2, b * h, sq_pad)
    assert got["partial"] == ((2, splits, b * kvh, skv, hd) if splits > 1
                              else None)


def test_bwd_kernel_names_are_the_sources_globals():
    """Every name of ``BWD_TC`` and ``BWD_CC`` is a ``__global__`` kernel of
    flash_attention_bwd.cu, the retired mma.sync kernels are gone, and no
    name is a substring of another (the profiler is read by substring)."""
    src = SOURCE.read_text()
    globals_ = set(re.findall(r"__global__ void[^\n]*\n(\w+)\(", src))
    assert set(fa.BWD_TC) | set(fa.BWD_CC) == globals_
    assert fa.BWD_TC == WGMMA + (REDUCE,) and fa.BWD_CC == CC
    assert "bwd_dkdv_tc_kernel" not in src and "bwd_dq_tc_kernel" not in src
    assert "mma.sync" not in src.split("#include")[-1]
    assert sorted(fa.BWD_KERNELS) == sorted(set(fa.BWD_TC + fa.BWD_CC))
    for a in fa.BWD_KERNELS:
        assert [b for b in fa.BWD_KERNELS if a in b] == [a]


def test_bwd_entry_takes_the_wrappers_arguments():
    """The C entry's parameters match the wrapper's ``argtypes``: eleven
    pointers before the sizes (the scratch after lse), the splits before
    the dtype, the stream last."""
    src = SOURCE.read_text()
    sig = re.search(r"int repro_flash_attention_bwd\((.*?)\)\s*\{", src,
                    re.S).group(1)
    decls = [d.strip() for d in sig.split(",")]
    names = [d.split()[-1].lstrip("*") for d in decls]
    assert names[:11] == ["q", "k", "v", "o", "dout", "lse", "rowstats",
                          "part", "dq", "dk", "dv"]
    assert names[-4:] == ["scale", "splits", "dtype", "stream"]
    assert len(decls) == len(fa._bwd_argtypes())
    assert all("*" in d for d in decls[:11])

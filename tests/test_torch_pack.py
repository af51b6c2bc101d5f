"""The port's text packing and host helpers against the JAX package.

Same inputs (numpy, from a seed) through ``myers_xla``'s jitted pack and
the port's torch ``pack``; the planes must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import myers_xla
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import plan
from sassy_tpu_torch.ops.myers_torch import PreparedText, pack

# each package gets its own profile objects
PROFILES = {
    "dna": profiles.Dna(),
    "iupac": profiles.Iupac(),
    "ascii": profiles.Ascii(case_sensitive=False),
}
REF_PROFILES = {
    "dna": ref_profiles.Dna(),
    "iupac": ref_profiles.Iupac(),
    "ascii": ref_profiles.Ascii(case_sensitive=False),
}


def _text(rng, prof_name, n):
    alphabet = {
        "dna": b"ACGTacgtNx",
        "iupac": b"ACGTNRYSWKMBDHVacgtn-X",
        "ascii": b"Hello, World! hello",
    }[prof_name]
    return rng.choice(np.frombuffer(alphabet, np.uint8), n)


@pytest.mark.parametrize("prof_name", ["dna", "iupac", "ascii"])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 4133])
def test_pack_equals_reference(prof_name, n):
    prof = PROFILES[prof_name]
    rng = np.random.default_rng(n)
    gw = plan._bucket_words(plan.cdiv(n, 32) + plan.TAIL_RESERVE_WORDS)
    buf = np.zeros(gw * 32, np.uint8)
    # bytes past n are garbage on purpose: pack must zero them
    buf[:] = _text(rng, prof_name, gw * 32)
    kw = dict(
        planes=prof.planes, with_valid=prof.eq_mode == "ascii",
        mode=prof.pack_mode, shift=prof.pack_shift, mask=prof.pack_mask,
        pmasks=tuple(prof.pack_plane_masks), fold=prof.pack_fold_case,
    )
    want = myers_xla._kernels()["pack_jit"](
        jnp.asarray(buf), np.int32(n // 32), np.int32(n % 32), **kw
    )
    got = pack(torch.from_numpy(buf), n // 32, n % 32, **kw)
    np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy())


@pytest.mark.parametrize("prof_name", ["dna", "iupac"])
def test_prepared_text_planes(prof_name):
    prof = PROFILES[prof_name]
    text = _text(np.random.default_rng(3), prof_name, 3001)
    want = myers_xla.PreparedText(REF_PROFILES[prof_name], text).planes
    got = PreparedText(prof, text, "cpu")
    assert got.gw == want.shape[1]
    np.testing.assert_array_equal(
        np.asarray(want).view(np.int32), got.planes.numpy()
    )
    # a reversed view (the reverse strand) packs as its reversed copy
    rev = PreparedText(prof, text[::-1], "cpu")
    np.testing.assert_array_equal(
        rev.planes.numpy(),
        PreparedText(prof, text[::-1].copy(), "cpu").planes.numpy(),
    )


def test_bucket_helpers_equal_reference():
    for x in list(range(0, 300)) + [1000, 4097, 1 << 20, (1 << 25) + 64]:
        assert plan._bucket_words(x) == myers_xla._bucket_words(x)
    for m in range(1, 1200):
        assert plan._bucket_rows(m) == myers_xla._bucket_rows(m)


@pytest.mark.parametrize("pattern", [b"ACGT", b"ACGTACGTAGGCTA" * 5,
                                     b"ANRY", b"acgtn", b"G" * 130])
@pytest.mark.parametrize("prof_name", ["dna", "iupac", "ascii"])
def test_pattern_inputs_equal_reference(pattern, prof_name):
    prof = PROFILES[prof_name]
    codes = prof.encode(pattern)
    want = myers_xla.pattern_inputs_np(REF_PROFILES[prof_name], codes, None,
                                       None)
    got = plan.pattern_inputs_np(prof, codes, None, None)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    assert want[3] == got[3]
    assert plan._masks_pure_np(*got[:2]) == myers_xla._masks_pure_np(*want[:2])


def test_plan_tiles():
    # a text that fits one tile needs no halo
    assert plan.plan_tiles(10, 1) == (1, 10, 0)
    # 1 GiB at 23 bp, k=3: enough tiles to fill the card, W >= 4 halos
    T, W, halo = plan.plan_tiles(1 << 25, plan.halo_words(24, 3))
    assert (halo, T * W >= 1 << 25, W >= 4 * halo) == (1, True, True)
    assert T >= plan.H100_TARGET_TILES // 2
    # long patterns: the halo grows, W follows it
    T, W, halo = plan.plan_tiles(1 << 20, plan.halo_words(1024, 40))
    assert halo == 40 and W >= 4 * halo and T * W >= 1 << 20

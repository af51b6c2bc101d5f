"""The port's entry points beside ``__graft_entry__.py``'s, on the CPU:
``entry("cpu")`` (the single engine's scan and selection on the flagship
config) against the JAX engine, and ``dryrun_multichip(n, device="cpu")``
(the sharded search of the reference dryrun's four scenarios with its
owner-computes checks) on meshes of 8, 4 and 1 slots."""

import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops.myers_xla import XlaEngine
from sassy_tpu_torch import graft_entry


def test_entry_equals_the_jax_engine():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert out.shape[0] == 2 and out.dtype == torch.int64
    # the same text and pattern as __graft_entry__.entry (numpy seed 0)
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=1 << 16)
    pattern = rng.choice(bases, size=23)
    prof = ref_profiles.Iupac()
    want = XlaEngine().candidates(prof, prof.encode(pattern), text, 3, None,
                                  None, False)
    assert sorted(map(tuple, out.T.tolist())) == sorted(want)
    inp = args[0]
    assert inp.k == 3 and inp.m_real == 23 and inp.eq_mode == "pure"


@pytest.mark.parametrize("n", [8, 4, 1])
def test_dryrun_multichip_on_the_cpu(n):
    done = graft_entry.dryrun_multichip(n, device="cpu")
    assert [d[0] for d in done] == ["overhang", "fast", "uneven tail",
                                    "Q % n_pat != 0"]
    assert done[3][1] == 3  # patterns, padded to 4 on 2 groups


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)

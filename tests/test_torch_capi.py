"""The port's C ABI (``sassy_tpu_torch/capi``), after tests/test_c_abi.py:
built with g++ into a temporary build directory, the example program run
with ``SASSY_DEVICE=cpu`` and the library driven through ctypes, both
equal to the port's ``Searcher``; without a card and with SASSY_DEVICE
unset, ``sassy_searcher`` returns NULL."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sassy_tpu_torch import Searcher, capi

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    return capi.build(build_dir=tmp_path_factory.mktemp("capi_build"))


def _env(**kw) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), *sys.path]))
    env.pop("SASSY_DEVICE", None)
    env.update(kw)
    return env


def test_build_writes_only_into_its_build_dir(built):
    lib, example = built
    assert lib.parent == example.parent
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, example.name])
    assert sorted(p.name for p in capi.HERE.iterdir()
                  if p.name != "__pycache__") == [
        "__init__.py", "example.c", "sassy_tpu.h", "sassy_tpu_torch_c.cc"]
    # built already: the same paths, nothing rebuilt
    assert capi.build(build_dir=lib.parent) == built


def test_example_on_the_cpu_equals_searcher(built):
    r = subprocess.run([str(built[1])], capture_output=True, text=True,
                       env=_env(SASSY_DEVICE="cpu"), timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "matches: 3" in r.stdout
    assert "[3, 7) cost=0 strand=+" in r.stdout
    assert "strand=-" in r.stdout
    want = Searcher("iupac", rc=True, device="cpu").search(
        b"ATCG", b"AAAATCGGGGATCCGG", 1)
    assert r.stdout.splitlines() == [f"matches: {len(want)}"] + [
        f"  [{m.text_start}, {m.text_end}) cost={m.cost} "
        f"strand={'-' if int(m.strand) else '+'}" for m in want]


_CTYPES = """
import ctypes, json, math, sys
lib = ctypes.CDLL(sys.argv[1])

class Match(ctypes.Structure):
    _fields_ = [("text_start", ctypes.c_size_t), ("text_end", ctypes.c_size_t),
                ("pattern_start", ctypes.c_size_t),
                ("pattern_end", ctypes.c_size_t),
                ("cost", ctypes.c_int32), ("strand", ctypes.c_uint8)]

lib.sassy_searcher.restype = ctypes.c_void_p
lib.sassy_searcher.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_double]
lib.sassy_search.restype = ctypes.c_size_t
lib.sassy_search.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_size_t, ctypes.c_char_p,
                             ctypes.c_size_t, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.POINTER(Match))]
lib.sassy_matches_free.argtypes = [ctypes.POINTER(Match), ctypes.c_size_t]
lib.sassy_searcher_free.argtypes = [ctypes.c_void_p]
out = []
for alphabet, rc, alpha, pat, text, k in json.load(sys.stdin):
    s = lib.sassy_searcher(alphabet.encode(), rc,
                           math.nan if alpha is None else alpha)
    assert s
    res = ctypes.POINTER(Match)()
    pat, text = pat.encode(), text.encode()
    n = lib.sassy_search(s, pat, len(pat), text, len(text), k,
                         ctypes.byref(res))
    assert n != ctypes.c_size_t(-1).value
    out.append([[res[i].text_start, res[i].text_end, res[i].pattern_start,
                 res[i].pattern_end, res[i].cost, res[i].strand]
                for i in range(n)])
    lib.sassy_matches_free(res, n)
    lib.sassy_searcher_free(s)
print(json.dumps(out))
"""


def _cases():
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = [("dna", 0, None, "ACGT", "TTACGTTT", 0)]
    for i in range(8):
        pat = rng.choice(acgt, int(rng.integers(4, 30)))
        text = rng.choice(acgt, int(rng.integers(50, 400)))
        at = int(rng.integers(0, len(text) - len(pat) // 2))
        copy = pat[: len(text) - at]
        text[at : at + len(copy)] = copy
        alphabet = ["dna", "iupac"][i % 2]
        alpha = 0.5 if alphabet == "iupac" and i % 4 == 1 else None
        out.append((alphabet, i % 3 != 0, alpha, bytes(pat).decode(),
                    bytes(text).decode(), int(rng.integers(0, 4))))
    out.append(("ascii", 1, None, "Hello", "say hallo, Hello!", 1))
    return out


def test_ctypes_equals_searcher(built):
    cases = _cases()
    r = subprocess.run([sys.executable, "-c", _CTYPES, str(built[0])],
                       input=json.dumps(cases), capture_output=True,
                       text=True, env=_env(SASSY_DEVICE="cpu"), timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    got = json.loads(r.stdout.splitlines()[-1])
    assert got[0] == [[2, 6, 0, 4, 0, 0]]
    for (alphabet, rc, alpha, pat, text, k), rows in zip(cases, got):
        want = Searcher(alphabet, rc=bool(rc), alpha=alpha,
                        device="cpu").search(pat.encode(), text.encode(), k)
        assert rows == [[m.text_start, m.text_end, m.pattern_start,
                         m.pattern_end, m.cost, int(m.strand)] for m in want]
    assert sum(map(len, got)) > len(cases)


def test_searcher_without_a_card_is_null(built):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([str(built[1])], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "no CUDA device" in r.stderr
    assert "failed to create searcher" in r.stderr
    assert r.stdout == ""

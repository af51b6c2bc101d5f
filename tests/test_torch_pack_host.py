"""The text pack kernel's per-word code, on the CPU.

``myers_torch.pack`` (the entry point all three engines call) runs
``pack_plain`` for a text on the CPU and the kernel
``myers_cuda.pack`` (``csrc/pack.cu``) for a text on a CUDA device. Here:
a g++ build of ``csrc/pack.cuh`` (the launch's byte-code table, a word's
bytes to its planes, the n mask and the store, through
``tests/torch_pack_host.cc``, which packs the words one after another)
equals the JAX package's jitted ``pack`` bit for bit, for DNA, IUPAC and
both ascii profiles, every nb, all 256 byte values, garbage bytes past n,
and a word index above 2^26; the entry point's dispatch on the CPU; the
kernel wrapper's refusals before any build. The kernel itself runs on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Then the chunking
of the upload to the card through two pinned staging buffers
(``myers_torch._stage_chunks``), with a staging of plain CPU tensors.
"""

import ctypes
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.ops import myers_xla
from sassy_tpu_torch import profiles
from sassy_tpu_torch.ops import myers_cuda, myers_torch, plan

# each package gets its own profile objects
PROFILES = {
    "dna": (profiles.Dna(), ref_profiles.Dna()),
    "iupac": (profiles.Iupac(), ref_profiles.Iupac()),
    "ascii_fold": (profiles.Ascii(case_sensitive=False),
                   ref_profiles.Ascii(case_sensitive=False)),
    "ascii": (profiles.Ascii(case_sensitive=True),
              ref_profiles.Ascii(case_sensitive=True)),
}


def _host():
    """The host program over pack.cuh, built with g++ into
    build/sassy_tpu_torch/."""
    from sassy_tpu_torch import gxx

    here = os.path.dirname(os.path.abspath(__file__))
    csrc = myers_cuda.CSRC
    lib = ctypes.CDLL(str(gxx.build(
        "pack_host", [os.path.join(here, "torch_pack_host.cc"),
                      csrc / "pack.cuh"],
        ["-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}"])))
    ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sassy_pack_host.argtypes = ([ptr, big, ptr] + [big] * 3 + [num] * 6
                                    + [ctypes.POINTER(ctypes.c_uint), num])
    lib.sassy_pack_host.restype = num
    return lib


def _kw(prof) -> dict:
    return dict(planes=prof.planes, with_valid=prof.eq_mode == "ascii",
                mode=prof.pack_mode, shift=prof.pack_shift,
                mask=prof.pack_mask, pmasks=tuple(prof.pack_plane_masks),
                fold=prof.pack_fold_case)


def _host_pack(lib, text: np.ndarray, gw: int, nw: int, nb: int, prof,
               word0: int = 0) -> np.ndarray:
    """The host program on ``text`` (all of it readable), as the wrapper
    drives the kernel: (planes + with_valid, gw) int32."""
    kw = _kw(prof)
    text = np.ascontiguousarray(text, np.uint8)
    out = np.full((kw["planes"] + kw["with_valid"], gw), -7, np.int32)
    pm = (ctypes.c_uint * myers_cuda.PACK_MAX_PLANES)(
        *[int(v) for v in kw["pmasks"]])
    err = lib.sassy_pack_host(
        text.ctypes.data if len(text) else None, len(text), out.ctypes.data,
        gw, word0, nw, nb, kw["planes"], int(kw["with_valid"]),
        myers_cuda.PACK_MODES[kw["mode"]], kw["shift"], kw["mask"], pm,
        int(kw["fold"]))
    assert err == 0
    return out


def _reference(buf: np.ndarray, nw: int, nb: int, ref_prof) -> np.ndarray:
    want = myers_xla._kernels()["pack_jit"](
        jnp.asarray(buf), np.int32(nw), np.int32(nb), **_kw(ref_prof))
    return np.asarray(want).view(np.int32)


@pytest.mark.parametrize("name", list(PROFILES))
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 4133])
def test_host_pack_equals_reference(name, n):
    """Random bytes of all 256 values, garbage past n: the host program
    given only the n bytes (as the engines upload them), and given the
    whole buffer, against the JAX pack of the buffer."""
    prof, ref_prof = PROFILES[name]
    gw = plan._bucket_words(plan.cdiv(n, 32) + plan.TAIL_RESERVE_WORDS)
    buf = np.random.default_rng(n).integers(0, 256, gw * 32, dtype=np.uint8)
    want = _reference(buf, n // 32, n % 32, ref_prof)
    lib = _host()
    got = _host_pack(lib, buf[:n].copy(), gw, n // 32, n % 32, prof)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _host_pack(lib, buf, gw, n // 32, n % 32, prof), want)


@pytest.mark.parametrize("name", list(PROFILES))
def test_host_pack_every_nb_and_byte(name):
    """Every byte value (two shuffled copies of 0..255 and mixed-case
    letters), n = 32 * 7 + nb for every nb, garbage past n."""
    prof, ref_prof = PROFILES[name]
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACGTNacgtnRYSWKMBDHVrysw-xZz@[`{", np.uint8)
    buf = np.concatenate([rng.permutation(256), rng.permutation(256),
                          letters]).astype(np.uint8)  # 16 + 1 words
    gw = len(buf) // 32
    lib = _host()
    for nb in range(32):
        nw = 7
        want = _reference(buf, nw, nb, ref_prof)
        got = _host_pack(lib, buf[: 32 * nw + nb], gw, nw, nb, prof)
        np.testing.assert_array_equal(got, want, err_msg=f"nb={nb}")
    # n at the buffer's end: every byte packed
    np.testing.assert_array_equal(
        _host_pack(lib, buf, gw, gw, 0, prof), _reference(buf, gw, 0,
                                                          ref_prof))


@pytest.mark.parametrize("name", list(PROFILES))
def test_host_pack_word_index_past_2_26(name):
    """Words 2^26 + 3 .. 2^26 + 8 of a text whose n lies in word 2^26 + 5
    (position past 2^31): the text pointer and the output start at word
    word0, so only six words of memory are used. Equal to the JAX pack of
    the same six words with n counted from word0."""
    prof, ref_prof = PROFILES[name]
    word0, gw = (1 << 26) + 3, 6
    nw, nb = word0 + 2, 19
    buf = np.random.default_rng(26).integers(0, 256, gw * 32, dtype=np.uint8)
    want = _reference(buf, nw - word0, nb, ref_prof)
    got = _host_pack(_host(), buf[: 32 * (nw - word0) + nb].copy(), gw, nw,
                     nb, prof, word0=word0)
    np.testing.assert_array_equal(got, want)
    assert 32 * (word0 + gw) > 1 << 31


def test_host_pack_refuses_bad_arguments():
    """The host program (like the kernel's C entry point) refuses nb
    outside 0..31, more than 8 planes, and no output words."""
    lib = _host()
    prof = PROFILES["dna"][0]
    pm = (ctypes.c_uint * 8)(*[int(v) for v in prof.pack_plane_masks])
    out = np.zeros((9, 4), np.int32)
    text = np.zeros(128, np.uint8)
    for gw, nb, planes in ((4, 32, 4), (4, 0, 9), (0, 0, 4)):
        assert lib.sassy_pack_host(
            text.ctypes.data, 128, out.ctypes.data, gw, 0, 1, nb, planes, 0,
            0, prof.pack_shift, prof.pack_mask, pm, 0) == 1


def test_pack_cpu_tensor_runs_the_plain_version():
    """On a CPU tensor the entry point calls its plain version once and
    launches nothing; a text of n bytes with gw words given packs as its
    zero-padded copy of gw * 32 bytes."""
    prof = PROFILES["ascii_fold"][0]
    kw = _kw(prof)
    rng = np.random.default_rng(5)
    n, gw = 1001, 40
    text = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
    calls, launches = myers_torch.pack_plain.calls, myers_cuda.pack.launches
    got = myers_torch.pack(text, n // 32, n % 32, gw=gw, **kw)
    assert myers_torch.pack_plain.calls == calls + 1
    assert myers_cuda.pack.launches == launches
    padded = torch.zeros(gw * 32, dtype=torch.uint8)
    padded[:n] = text
    want = myers_torch.pack_plain(padded, n // 32, n % 32, **kw)
    assert got.shape == (9, gw) and torch.equal(got, want)


def test_pack_bound_counts_one_read_and_one_write():
    """``diagnostics.pack_bound``: the bytes read once and the plane words
    written once over 3.35 TB/s (1.5 GiB for 1 GiB of DNA, 2.125 GiB for
    ascii's 8 planes and validity), against one operation a byte."""
    from sassy_tpu_torch import diagnostics

    gib = 1 << 30
    for planes, valid, nbytes in ((4, False, 3 * gib // 2),
                                  (8, True, 17 * gib // 8)):
        got = diagnostics.pack_bound(gib, planes, valid)
        assert (got["bytes"], got["ops"], got["bound_by"]) == (nbytes, gib,
                                                               "bytes")
        assert got["bound_ms"] == pytest.approx(
            nbytes / diagnostics.MEM_BYTES_PER_S * 1e3)
    # the output's words as given (a bucketed plane width)
    assert diagnostics.pack_bound(100, 4, False, gw=10)["bytes"] == 260


@pytest.mark.parametrize("bad", ["dtype", "dim", "device"])
def test_pack_kernel_refuses_before_any_launch(bad):
    """The kernel wrapper raises ValueError on a text it does not take
    (another dtype, not 1-D, not on a CUDA device) before building or
    launching anything."""
    kw = _kw(PROFILES["dna"][0])
    text = {"dtype": torch.zeros(64, dtype=torch.int32, device="meta"),
            "dim": torch.zeros((2, 32), dtype=torch.uint8, device="meta"),
            "device": torch.zeros(64, dtype=torch.uint8, device="meta")}[bad]
    launches = myers_cuda.pack.launches
    with pytest.raises(ValueError):
        myers_cuda.pack(text, 1, 0, **kw)
    with pytest.raises(ValueError):
        myers_torch.pack(text, 1, 0, **kw)
    assert myers_cuda.pack.launches == launches


# ---------------------------------------------------------------------------
# the upload to the card through two pinned staging buffers, its chunking
# on the CPU (a staging whose buffers are plain tensors and whose send is
# a synchronous copy)


class _HostStaging:
    """The staging's interface on the CPU; records each call."""

    def __init__(self):
        self.bufs = [torch.full((myers_torch.STAGE_BYTES,), 0xAA,
                                dtype=torch.uint8) for _ in range(2)]
        self.lock = threading.Lock()
        self.calls = []
        self.out = None

    def begin(self, out):
        self.out = out
        self.calls.append(("begin",))

    def wait(self, slot):
        self.calls.append(("wait", slot))

    def send(self, slot, dst, n):
        dst.copy_(self.bufs[slot][:n])
        self.calls.append(("send", slot, dst.data_ptr() - self.out.data_ptr(),
                           n))

    def end(self, out):
        self.calls.append(("end",))


@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 13, 14, 15, 21, 22, 100])
def test_upload_chunks_every_byte_once_in_order(monkeypatch, n):
    """Chunks of STAGE_BYTES (7 here) at and around the edges: the chunks
    tile the text in order, alternate the two buffers, each waited for
    before it is refilled; the upload equals the text, for an array, its
    read-only twin (bytes) and a reversed view (the reverse strand)."""
    monkeypatch.setattr(myers_torch, "STAGE_BYTES", 7)
    staging = _HostStaging()
    monkeypatch.setattr(myers_torch, "_staging_for", lambda device: staging)
    a = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for text, want in ((a, a), (a.tobytes(), a), (a[::-1], a[::-1])):
        staging.calls.clear()
        got = myers_torch._upload(text, "cpu")
        assert got.dtype == torch.uint8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
        if n == 0:  # nothing to stage
            assert staging.calls == []
            continue
        chunks = -(-n // 7)
        want_calls = [("begin",)]
        for i in range(chunks):
            want_calls += [("wait", i % 2),
                           ("send", i % 2, 7 * i, min(7, n - 7 * i))]
        assert staging.calls == want_calls + [("end",)]

"""The port's sharded search over several processes: real
``torch.distributed`` jobs of 2 processes x 4 slots and 4 processes x 2
slots, on the CPU over gloo (``multihost.initialize`` with a localhost
coordinator, then ``multihost.global_search`` over the 8-slot mesh). Every
rank's lists must equal the port's one-process ``ShardedSearch`` over the
same 8 slots and the JAX reference's in-process result on the inputs of
tests/test_multihost.py; the worker processes import no JAX and nothing
of the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from sassy_tpu import profiles as ref_profiles
from sassy_tpu.parallel import ShardedSearch as RefShardedSearch
from sassy_tpu.parallel import make_mesh as ref_make_mesh
from sassy_tpu_torch import profiles
from sassy_tpu_torch.parallel import ShardedSearch, make_mesh, multihost

REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np

    coord, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, {repo!r})
    import torch.distributed as dist
    from sassy_tpu_torch.parallel import multihost
    from sassy_tpu_torch.profiles import Iupac

    multihost.initialize(coordinator_address=coord, num_processes=nproc,
                         process_id=pid)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
    per = 8 // nproc
    out = {{"shard": multihost.host_shard_of(10)}}
    for name, pats, text, k, kw in {cases!r}:
        pats = [np.frombuffer(p.encode(), np.uint8) for p in pats]
        text = np.frombuffer(text.encode(), np.uint8)
        n_pat = kw.pop("n_pat", 1)
        out[name] = multihost.global_search(
            Iupac(), pats, text, k, n_pat=n_pat, slots_per_rank=per,
            device="cpu", **kw)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "sassy_tpu"))
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
    """
)


def _cases():
    """tests/test_multihost.py's inputs, then overhang and a pattern axis
    of 2 groups over 3 patterns on the same text."""
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=5000)
    pats = [rng.choice(bases, size=9) for _ in range(2)]
    text[100:109] = pats[0]
    more = [rng.choice(bases, size=9) for _ in range(1)]
    text[3001:3010] = more[0]
    s = lambda a: bytes(a).decode()  # noqa: E731
    return [
        ("fast", [s(p) for p in pats], s(text), 2, {}),
        ("overhang", [s(p) for p in pats], s(text), 2, {"alpha": 0.5}),
        ("pat axis", [s(p) for p in pats + more], s(text), 2, {"n_pat": 2}),
    ]


def _run(tmp_path, nproc: int) -> list[dict]:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(REPO), cases=_cases()))
    procs = [subprocess.Popen(
        [sys.executable, str(script), addr, str(i), str(nproc)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""))
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines()
                        if ln.startswith("RESULT "))
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    return outs


def _in_process(name, pats, text, k, kw):
    kw = dict(kw)
    n_pat = kw.pop("n_pat", 1)
    enc = lambda x: np.frombuffer(x.encode(), np.uint8)  # noqa: E731
    pats, text = [enc(p) for p in pats], enc(text)
    port = ShardedSearch(mesh=make_mesh(8 // n_pat, n_pat, device="cpu"))
    got = port.candidates_batch(profiles.Iupac(), pats, text, k, **kw)
    ref = RefShardedSearch(mesh=ref_make_mesh(n_text=8 // n_pat, n_pat=n_pat),
                           backend="xla").candidates_batch(
        ref_profiles.Iupac(), pats, text, k, **kw)
    return got, ref


@pytest.mark.parametrize("nproc", [2, 4])
def test_processes_equal_one_process_and_reference(tmp_path, nproc):
    outs = _run(tmp_path, nproc)
    shards = [tuple(o["shard"]) for o in outs]
    assert shards[0][0] == 0 and shards[-1][1] == 10
    assert all(a[1] == b[0] for a, b in zip(shards, shards[1:]))
    for name, pats, text, k, kw in _cases():
        got, ref = _in_process(name, pats, text, k, kw)
        want = [sorted(map(list, c)) for c in got]
        assert want == [sorted(map(list, c)) for c in ref], name
        assert any(want), name
        for rank, o in enumerate(outs):
            assert [sorted(c) for c in o[name]] == want, (name, rank)
    assert all(o["imported"] == [] for o in outs)


def test_one_process_needs_no_group(monkeypatch):
    """Without an address or torch's environment, initialize() is a no-op
    and global_search runs over this process's slots."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    multihost.initialize()
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert multihost.host_shard_of(7) == (0, 7)
    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=800)
    pats = [text[200:212].copy(), text[600:612].copy()]
    got = multihost.global_search(profiles.Iupac(), pats, text, 1,
                                  slots_per_rank=4, device="cpu")
    assert got == ShardedSearch(mesh=make_mesh(4, device="cpu")
                                ).candidates_batch(profiles.Iupac(), pats,
                                                   text, 1)
    assert (212, 0) in got[0] and (612, 0) in got[1]
    with pytest.raises(ValueError):
        multihost.global_search(profiles.Iupac(), pats, text, 1, n_pat=3,
                                device="cpu")


_LOCAL_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE")


@pytest.mark.parametrize("case", [
    # torchrun on 2 hosts x 8 cards, rank 9 = host 1's local rank 1
    dict(cards=8, env={"MASTER_ADDR": "h0", "WORLD_SIZE": "16", "RANK": "9",
                       "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"},
         kw={}, want=("nccl", 1, 9, 16)),
    # the same host's ranks named by arguments
    dict(cards=4, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=8, process_id=6,
                                  local_rank=2, local_world_size=4),
         want=("nccl", 2, 6, 8)),
    # one host, no word of hosts: every rank local
    dict(cards=2, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=2, process_id=1),
         want=("nccl", 1, 1, 2)),
    # one host, 2 ranks, 1 card: NCCL cannot, and gloo only when asked
    dict(cards=1, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=2, process_id=1),
         want=ValueError),
    dict(cards=1, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=2, process_id=1,
                                  share_cards=True),
         want=("gloo", 0, 1, 2)),
    # 2 hosts x 8 ranks on 8 cards, but the host's share is not given
    dict(cards=8, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=16, process_id=9),
         want=ValueError),
    dict(cards=8, env={"LOCAL_WORLD_SIZE": "8"},
         kw=dict(coordinator_address="h0:1", num_processes=16,
                 process_id=9),
         want=ValueError),
    # no card: gloo on the CPU
    dict(cards=0, env={}, kw=dict(coordinator_address="h0:1",
                                  num_processes=4, process_id=3),
         want=("gloo", None, 3, 4)),
], ids=["torchrun-2x8", "args-2x4", "one-host", "1-card-2-ranks",
        "1-card-shared", "2x8-no-local", "2x8-no-local-rank", "cpu"])
def test_initialize_chooses_the_backend_per_host(monkeypatch, case):
    """The backend and card come from this host's share of the ranks, not
    from the world size; no case falls back to gloo unasked."""
    import torch
    import torch.distributed as dist

    for name in _LOCAL_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in case["env"].items():
        monkeypatch.setenv(name, value)
    cards = case["cards"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = {"card": None}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda c: seen.update(card=c))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    if case["want"] is ValueError:
        with pytest.raises(ValueError):
            multihost.initialize(**case["kw"])
        assert "backend" not in seen and seen["card"] is None
        return
    multihost.initialize(**case["kw"])
    assert (seen["backend"], seen["card"], seen["rank"],
            seen["world_size"]) == case["want"]

"""canvas_tpu_torch's multi-device layer against canvas_tpu's on the CPU:
contig shards, mesh shapes, the kill switch, the host-data gather in 4
gloo processes, the lane-split HMM decodes on a [cpu] * 8 mesh (canvas_tpu's
conftest gives it 8 virtual devices, so its sharded path runs) and the
round-robin binning on a [cpu] * 4 mesh with B1's plain version."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from canvas_tpu.ops import binning as jax_binning
from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu.parallel import distributed as jax_dist
from canvas_tpu.parallel import mesh as jax_mesh
from canvas_tpu_torch.ops import binning, hmm
from canvas_tpu_torch.parallel import distributed, mesh
from tests.test_torch_joint_hmm import _multichunk_input

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# a group's processes are joined within this many seconds, then killed
JOIN_S = 120


def _lengths(seed: int) -> dict[str, int]:
    """Seeded contig lengths: hg38-like spread, with ties in seed 2."""
    rng = np.random.default_rng(seed)
    if seed == 2:
        return {f"chr{i}": int(x) for i, x in
                enumerate(rng.choice([50_000, 80_000, 80_000, 120_000], 24))}
    return {f"chr{i}": int(x) for i, x in
            enumerate(rng.integers(10_000, 250_000_000, 3 + 7 * seed))}


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("seed", range(3))
def test_contig_shards_equal_canvas_tpu(seed, n):
    lengths = _lengths(seed)
    shards = distributed.contig_shards(lengths, n)
    assert shards == jax_dist.contig_shards(lengths, n)
    assert sorted(c for s in shards for c in s) == sorted(lengths)
    for k in range(n):
        assert distributed.contig_shards(lengths, n, k) == shards[k]


def test_my_contigs_single_process_covers_all():
    assert distributed.rank() == 0 and distributed.world_size() == 1
    assert distributed.my_contigs({"chr1": 100, "chr2": 50}) == \
        ["chr1", "chr2"]
    assert distributed.initialize() == (0, 1)


@pytest.mark.parametrize("axes", [("contig",), ("contig", "pos")])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_equal_canvas_tpu(n, axes):
    want = jax_mesh.make_mesh(n, axes)
    got = mesh.make_mesh(n, axes, devices=[CPU] * 8)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert all(d == CPU for d in got.devices.flat)


def test_make_mesh_needs_enough_devices(monkeypatch):
    with pytest.raises(ValueError, match="9 devices"):
        mesh.make_mesh(9, devices=[CPU] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.lane_devices()


def test_sharding_kill_switch(monkeypatch):
    monkeypatch.delenv("CANVAS_TPU_FORCE_SINGLE_DEVICE", raising=False)
    assert mesh.sharding_enabled() == jax_mesh.sharding_enabled() is True
    assert mesh.lane_devices(devices=[CPU] * 4) == [CPU] * 4
    assert mesh.lane_devices("cpu") == [CPU]
    monkeypatch.setenv("CANVAS_TPU_FORCE_SINGLE_DEVICE", "1")
    assert mesh.sharding_enabled() == jax_mesh.sharding_enabled() is False
    assert mesh.lane_devices(devices=[CPU] * 4) == [CPU]
    m2 = mesh.make_mesh(4, ("contig", "pos"), devices=[CPU] * 4)
    assert mesh.lane_devices(devices=m2) == [CPU]


def test_placement_helpers():
    m = mesh.make_mesh(6, ("contig", "pos"), devices=[CPU] * 6)
    assert m.shape == {"contig": 2, "pos": 3}
    x = torch.arange(24).reshape(6, 4)
    parts = mesh.split_lanes(x, mesh.lane_devices(devices=m))
    assert [p.shape for p in parts] == [(3, 4), (3, 4)]
    assert torch.equal(mesh.gather_lanes(parts, CPU), x)
    pos = mesh.split_positions(torch.arange(12), m)
    assert [p.tolist() for p in pos] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                         [8, 9, 10, 11]]
    cols = mesh.split_positions(x, mesh.make_mesh(2, devices=[CPU] * 2),
                                axis=1)
    assert torch.equal(torch.cat(cols, dim=1), x)
    assert all(torch.equal(r, x) for r in mesh.replicate(x, [CPU] * 3))
    with pytest.raises(ValueError, match="pad_lanes_to_multiple"):
        mesh.split_lanes(torch.zeros(5, 2), [CPU] * 2)
    with pytest.raises(ValueError, match="does not split"):
        mesh.split_positions(torch.zeros(10), m)


@pytest.mark.parametrize("b,multiple", [(5, 8), (8, 4), (3, 3), (1, 2)])
def test_pad_lanes_to_multiple_equals_canvas_tpu(b, multiple):
    arr = np.arange(b * 6, dtype=np.float32).reshape(b, 3, 2)
    msk = np.ones((b, 3), bool)
    got = mesh.pad_lanes_to_multiple(arr, msk, multiple)
    want = jax_mesh.pad_lanes_to_multiple(arr, msk, multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_all_gather_host_data_single_process_identity():
    local = {"chr1": np.arange(5), "chr2": np.ones(3)}
    out = distributed.all_gather_host_data(local)
    assert set(out) == {"chr1", "chr2"}
    assert np.array_equal(out["chr1"], local["chr1"])
    assert out is not local


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(n: int, args: list[str], workdir: Path,
              timeout: float = JOIN_S) -> list[tuple[int, str, str]]:
    """n processes `python <args> 127.0.0.1:<port> n rank`, run from the
    repo root with one intra-op thread each; joined within `timeout`
    seconds, else killed and the test fails.  Returns (exit code, stdout,
    stderr) a process."""
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(n):
        out = open(workdir / f"p{rank}.out", "w+")
        err = open(workdir / f"p{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, *args, addr, str(n), str(rank)], cwd=REPO,
            env=env, stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"a process of the group of {n} did not finish within "
                    f"{timeout} s")
    res = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        res.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return res


GATHER_WORKER = """
import sys
import numpy as np
from canvas_tpu_torch.parallel import distributed

addr, n, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert distributed.initialize(addr, n, rank) == (rank, n)
lengths = {f"chr{i}": 1_000 + 7_919 * i for i in range(1, 8)}
dtypes = {c: (np.int16 if c == "chr3" else np.uint8) for c in lengths}
full = {c: np.random.default_rng(i).integers(0, 120, L).astype(dtypes[c])
        for i, (c, L) in enumerate(lengths.items())}
mine = distributed.my_contigs(lengths)
local = {c: full[c] for c in mine}
try:
    distributed.all_gather_host_data(local)
    raise SystemExit("no ValueError without shapes")
except ValueError:
    pass
out = distributed.all_gather_host_data(
    local, {c: (L, dtypes[c]) for c, L in lengths.items()})
distributed.shutdown()
ok = sorted(out) == sorted(full) and all(
    out[c].dtype == full[c].dtype and np.array_equal(out[c], full[c])
    for c in full)
print("MINE", ",".join(mine))
print("EQUAL", ok)
"""


def test_all_gather_host_data_in_four_gloo_processes(tmp_path):
    """Each process owns its contig_shards subset (canvas_tpu's); the
    gathered data equal the full data in every process."""
    lengths = {f"chr{i}": 1_000 + 7_919 * i for i in range(1, 8)}
    res = run_group(4, ["-c", GATHER_WORKER], tmp_path)
    for rank, (rc, out, err) in enumerate(res):
        assert rc == 0, err
        lines = dict(ln.split(" ", 1) for ln in out.splitlines())
        assert lines["EQUAL"] == "True"
        mine = [c for c in lines["MINE"].split(",") if c]
        assert mine == jax_dist.contig_shards(lengths, 4, rank)


def _five_lanes():
    """tests/test_mesh_distributed.py's 5-lane input (padded to 8)."""
    rng = np.random.default_rng(5)
    cov = {}
    for i in range(5):
        c = rng.poisson(100, size=700 + 50 * i).astype(np.float64)
        c[200:300] *= 2
        cov[f"chr{i}"] = c
    return cov


def _multichunk_single():
    """Four contigs of one sample, 2,000-9,000 bins (up to 36 chunks of
    256), and a contig too short to decode: the multi-chunk trio's
    proband."""
    return {c: np.ascontiguousarray(v[:, 2])
            for c, v in _multichunk_input().items()}


def _record_decodes(monkeypatch) -> list:
    """Record the lanes and device of every decode hmm runs."""
    calls = []
    decode = hmm.viterbi_decode_chunked

    def recording(log_em, mask, *a, **kw):
        calls.append((log_em.shape[0], log_em.device))
        return decode(log_em, mask, *a, **kw)

    monkeypatch.setattr(hmm, "viterbi_decode_chunked", recording)
    return calls


PER_SAMPLE = {"five_lanes": _five_lanes, "multichunk": _multichunk_single}


@pytest.mark.parametrize("case", sorted(PER_SAMPLE))
def test_segment_coverage_batched_split_equals_canvas_tpu(case, monkeypatch):
    """The lane-split PerSampleHMM decode on [cpu] * 8: 8 groups of one
    lane, breakpoints equal to canvas_tpu's sharded decode and to the
    port's unsplit one."""
    cov = PER_SAMPLE[case]()
    want = jax_hmm.segment_coverage_batched(cov)
    calls = _record_decodes(monkeypatch)
    split = hmm.segment_coverage_batched(cov, devices=[CPU] * 8)
    assert calls == [(1, CPU)] * 8
    whole = hmm.segment_coverage_batched(cov, device="cpu")
    n_live = sum(len(c) > 10 for c in cov.values())
    assert calls[8:] == [(hmm._next_pow2(n_live), CPU)]
    assert split == whole == want
    assert sum(len(b) >= 2 for b in split.values()) >= 3


def test_segment_coverage_batched_three_devices_stay_whole(monkeypatch):
    """canvas_tpu's rule: B is padded to next_pow2(n) = 4 and, since 3
    does not divide it, the decode runs unsplit on the first device."""
    cov = _five_lanes()
    calls = _record_decodes(monkeypatch)
    got = hmm.segment_coverage_batched(cov, devices=[CPU] * 3)
    assert calls == [(8, CPU)]
    assert got == hmm.segment_coverage_batched(cov, device="cpu")


JOINT = {"multichunk_trio": _multichunk_input,
         "five_lanes_1d": _five_lanes}


@pytest.mark.parametrize("case", sorted(JOINT))
def test_segment_coverage_joint_batched_split_equals_canvas_tpu(
        case, monkeypatch):
    cov = JOINT[case]()
    want = jax_hmm.segment_coverage_joint_batched(cov)
    calls = _record_decodes(monkeypatch)
    split = hmm.segment_coverage_joint_batched(cov, devices=[CPU] * 8)
    assert calls == [(1, CPU)] * 8
    whole = hmm.segment_coverage_joint_batched(cov, device="cpu")
    assert split == whole == want


def test_decode_split_with_the_kill_switch_is_unsplit(monkeypatch):
    monkeypatch.setenv("CANVAS_TPU_FORCE_SINGLE_DEVICE", "1")
    cov = _five_lanes()
    calls = _record_decodes(monkeypatch)
    got = hmm.segment_coverage_batched(cov, devices=[CPU] * 8)
    assert calls == [(8, CPU)]                    # next_pow2(5), unsplit
    monkeypatch.delenv("CANVAS_TPU_FORCE_SINGLE_DEVICE")
    assert got == jax_hmm.segment_coverage_batched(cov)


def _bin_tracks():
    """tests/test_mesh_distributed.py's round-robin binning input."""
    rng = np.random.default_rng(9)
    tracks = {}
    for i in range(4):
        L = 4096 * (i + 1)
        possible = rng.random(L) < 0.8
        observed = rng.poisson(0.5, size=L).astype(np.uint8)
        observed[~possible] = 0
        tracks[f"chr{i}"] = dict(possible=possible, observed=observed,
                                 is_gc=rng.random(L) < 0.4, offset=0)
    return tracks


def test_contig_placement_round_robin_longest_first():
    tracks = _bin_tracks()
    assert binning.contig_placement(tracks, ["a", "b", "c", "d"]) == {
        "chr3": "a", "chr2": "b", "chr1": "c", "chr0": "d"}
    assert binning.contig_placement(tracks, ["a", "b"]) == {
        "chr3": "a", "chr2": "b", "chr1": "a", "chr0": "b"}


def test_bin_sample_round_robin_equals_canvas_tpu(monkeypatch):
    """bin_sample over [cpu] * 4 with B1's plain version: every contig
    through the fused path, bins equal to bin_contig_np and to
    canvas_tpu's fused bin_sample (Pallas interpret mode)."""
    tracks = _bin_tracks()
    fused = []
    original = binning.bin_contig_device_fused

    def recording(p_bits, *a, **kw):
        fused.append(p_bits.device)
        return original(p_bits, *a, **kw)

    monkeypatch.setattr(binning, "bin_contig_device_fused", recording)
    got = binning.bin_sample(dict(tracks), 64, force_fused=True,
                             device="cpu", devices=[CPU] * 4)
    assert fused == [CPU] * 4
    want = jax_binning.bin_sample(dict(tracks), 64, force_fused=True)
    for n, t in tracks.items():
        host = binning.bin_contig_np(t["possible"], t["observed"],
                                     t["is_gc"], 64, t["offset"],
                                     "TruncatedDynamicRange")
        for a, b, c in zip(got[n], want[n], host):
            assert np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64)), n
            assert np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(c, np.float64)), n

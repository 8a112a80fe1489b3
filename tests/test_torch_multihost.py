"""Port: several processes over torch.distributed (parallel/multihost.py),
on the CPU with the gloo backend.

- LocalShardFeeder in one process, fed into a real sharded model.
- Two processes: bootstrap, each feeds its own shards of a global batch,
  and one collective.
- Two processes through a kill and a resume mid-window from per-process
  checkpoints: the host-partial flows_5m rows of both, merged by key,
  are exactly the oracle's (nothing lost to the crash, nothing counted
  twice by the replay), and the merged top-K rows are identical on both
  ranks and exact.
- reassign_lost_partitions equals the reference's on several maps.
- Four processes, one lost for good with nothing durable; the three
  survivors form a new world and re-consume its partition from its
  committed offset: held against the oracle.

Every subprocess imports only the port (no JAX) and has its own timeout,
so a hang fails its test instead of eating the suite's clock.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from flow_pipeline_tpu.parallel import multihost as jmulti
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.models import HeavyHitterConfig
from flow_pipeline_tpu_torch.models.oracle import exact_groupby
from flow_pipeline_tpu_torch.parallel import (LocalShardFeeder,
                                              ShardedHeavyHitter, make_mesh)
from flow_pipeline_tpu_torch.parallel import multihost as tmulti
from flow_pipeline_tpu_torch.schema.batch import FlowBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 120  # seconds, per subprocess


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_procs(script, phase, ckpt, outdir, nprocs, expect_crash=False):
    """``nprocs`` processes of ``script`` in one new process group; their
    outputs. Each has TIMEOUT seconds; on a timeout all are killed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), phase, str(ckpt),
         str(outdir), str(nprocs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        pytest.fail(f"{phase}: a process outlived its {TIMEOUT}-s timeout")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if expect_crash:
            assert f"SNAPSHOT_DONE {pid}" in out, \
                f"{phase} process {pid} never snapshotted:\n{out}"
        else:
            assert p.returncode == 0, f"{phase} process {pid}:\n{out}"
    return outs


# ---- one process --------------------------------------------------------------


def test_feeder_places_rows_on_the_local_shards():
    mesh = make_mesh(8, devices="cpu")
    n = 64  # 8 rows per shard
    cols = {"bytes": np.arange(n, dtype=np.uint64),
            "src_addr": np.tile(np.arange(4, dtype=np.uint32), (n, 1))}
    out, valid = LocalShardFeeder(mesh).feed_columns(cols, np.ones(n, bool))
    assert len(out) == len(valid) == 8
    assert out[3]["bytes"].tolist() == list(range(24, 32))
    assert out[3]["src_addr"].shape == (8, 4)
    assert all(v.all() for v in valid)
    with pytest.raises(ValueError, match="equal"):
        LocalShardFeeder(mesh).feed_columns(cols, np.ones(60, bool))


def test_fed_columns_drive_a_sharded_model():
    from flow_pipeline_tpu_torch.models.oracle import topk_exact

    mesh = make_mesh(8, devices="cpu")
    model = ShardedHeavyHitter(HeavyHitterConfig(batch_size=256,
                                                 width=1 << 10, capacity=32),
                               mesh)
    batch = FlowGenerator(ZipfProfile(n_keys=40, alpha=1.6),
                          seed=77).batch(2048)
    padded, mask = batch.pad_to(2048)
    cols = padded.device_columns(["src_addr", "dst_addr", "bytes", "packets",
                                  "sampling_rate"])
    fed, valid = LocalShardFeeder(mesh).feed_columns(cols, mask)
    model.update_device_columns(fed, valid)
    assert model.chunk_updates == 8
    want = topk_exact(batch, ["src_addr", "dst_addr"], 1)
    assert (model.top(1)["src_addr"][0] == want["src_addr"][0]).all()


# ---- reassignment ---------------------------------------------------------------


@pytest.mark.parametrize("lost,survivors,n_batches", [
    ({3: 0}, [0, 1, 2], 8),
    ({5: 6, 7: 8}, [1, 2], 8),
    ({2: 1, 3: 4}, [0, 1], 6),
    ({0: 0, 1: 3, 9: 2}, [2, 4, 6, 8], 7),
    ({4: 9}, [0], 5),
])
def test_reassign_lost_partitions_matches_reference(lost, survivors,
                                                    n_batches):
    got = tmulti.reassign_lost_partitions(lost, survivors, n_batches)
    assert got == jmulti.reassign_lost_partitions(lost, survivors, n_batches)
    # deterministic, disjoint and complete from the committed offsets
    slices = sorted(sl for w in got.values() for sl in w)
    assert slices == sorted((p, b) for p, off in lost.items()
                            for b in range(off, n_batches))


# ---- two processes ---------------------------------------------------------------

_PRELUDE = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from flow_pipeline_tpu_torch.parallel import make_mesh
from flow_pipeline_tpu_torch.parallel.multihost import (
    LocalShardFeeder, MultihostPipeline, init_distributed,
    reassign_lost_partitions)
pid, port, phase = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ckpt, outdir, nprocs = sys.argv[4], sys.argv[5], int(sys.argv[6])
init_distributed(f"127.0.0.1:{port}", nprocs, pid, backend="gloo",
                 device="cpu", timeout=90)
"""

BOOTSTRAP = _PRELUDE + textwrap.dedent("""
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    init_distributed(f"127.0.0.1:{port}", nprocs, pid)  # idempotent
    mesh = make_mesh(4)  # 4 shards, 2 in each process, on the CPU
    assert mesh.local_size == 2 and mesh.local_start == 2 * pid
    # each process contributes its own half of the global batch
    cols, valid = LocalShardFeeder(mesh).feed_columns(
        {"x": np.full(8, float(pid + 1), np.float32)}, np.ones(8, bool))
    assert [c["x"].shape[0] for c in cols] == [4, 4]
    total = torch.stack([c["x"].sum() for c in cols]).sum()
    dist.all_reduce(total)  # the cross-process collective
    assert float(total) == 8 * 1 + 8 * 2, float(total)
    print("MULTIHOST_OK", pid, float(total), flush=True)
    dist.destroy_process_group()
""")


def test_two_processes_bootstrap_feed_and_collective(tmp_path):
    script = tmp_path / "boot.py"
    script.write_text(BOOTSTRAP)
    outs = _run_procs(script, "boot", tmp_path, tmp_path, 2)
    for pid, out in enumerate(outs):
        assert f"MULTIHOST_OK {pid} 24.0" in out


_STREAM = """
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.models import HeavyHitterConfig, WindowAggConfig
COLS = ("time_received", "src_as", "dst_as", "etype", "bytes", "packets",
        "src_addr", "dst_addr", "sampling_rate")
def pipeline(mesh, per_shard):
    return MultihostPipeline(
        mesh, WindowAggConfig(batch_size=per_shard),
        {"top_pairs": HeavyHitterConfig(
            key_cols=("src_addr", "dst_addr"), batch_size=per_shard,
            width=1 << 10, capacity=64)}, k=20)
def emit(rows):
    f5 = rows["flows_5m"]
    with open(os.path.join(outdir, f"flows5m_{pid}.json"), "w") as f:
        json.dump({k: np.asarray(v).tolist() for k, v in f5.items()}, f)
    # the merged top-K from EVERY rank: the test holds them identical
    with open(os.path.join(outdir, f"top_{pid}.json"), "w") as f:
        json.dump({k: np.asarray(v).tolist()
                   for k, v in rows["top_pairs"].items()}, f)
"""

KILL_RESUME = _PRELUDE + _STREAM + textwrap.dedent("""
    PER, N_BATCHES = 128, 8
    mesh = make_mesh(4)  # 2 shards per process
    GLOBAL, HALF = PER * 4, PER * 2
    pipe = pipeline(mesh, PER)
    start = 0
    if phase == "resume":
        start = pipe.restore(os.path.join(ckpt, str(pid)))
        assert start == 5, start  # batch 5 ran but was never snapshotted
    # both processes derive the same global stream; each consumes its
    # own contiguous half (the consumer-group partition split)
    gen = FlowGenerator(ZipfProfile(n_keys=30, alpha=1.4), seed=5, t0=9000)
    batches = [gen.batch(GLOBAL) for _ in range(N_BATCHES)]
    mine = slice(pid * HALF, (pid + 1) * HALF)
    for i in range(start, N_BATCHES):
        cols = batches[i].device_columns(COLS)
        local = {k: np.ascontiguousarray(v[mine]) for k, v in cols.items()}
        wm = int(batches[i].columns["time_received"].max())
        pipe.update(local, np.ones(HALF, bool), wm)
        if phase == "first":
            if i == 4:
                pipe.snapshot(os.path.join(ckpt, str(pid)))
                # both snapshots durable before either may crash (the hot
                # path has no collective: the processes run free)
                dist.barrier()
                print("SNAPSHOT_DONE", pid, flush=True)
            if i == 5:  # crash mid-window, after an unsnapshotted batch
                print("KILLED", pid, flush=True)
                os._exit(0)
    emit(pipe.flush(force=True))
    print("MULTIHOST_E2E_OK", pid, flush=True)
    dist.destroy_process_group()
""")


def _stream(seed, n_batches, rows):
    gen = FlowGenerator(ZipfProfile(n_keys=30, alpha=1.4), seed=seed,
                        t0=9000)
    return FlowBatch.concat([gen.batch(rows) for _ in range(n_batches)])


def _merged_flows_5m(outdir, pids) -> dict:
    merged: dict[tuple, list] = {}
    for pid in pids:
        rows = json.loads((outdir / f"flows5m_{pid}.json").read_text())
        for i in range(len(rows["timeslot"])):
            key = (rows["timeslot"][i], rows["src_as"][i],
                   rows["dst_as"][i], rows["etype"][i])
            acc = merged.setdefault(key, [0, 0, 0])
            for j, c in enumerate(("bytes", "packets", "count")):
                acc[j] += rows[c][i]
    return merged


def _check_against_oracle(outdir, pids, full) -> None:
    """flows_5m: the ranks' host-partial rows merged by key equal the
    oracle over the whole stream. top-K: identical on every rank, each
    row's sums exact (capacity 64 > 30 keys: nothing evicted) and the 20
    heaviest pairs all present."""
    want = exact_groupby(full, ["src_as", "dst_as", "etype"], timeslot=True)
    assert _merged_flows_5m(outdir, pids) == {
        (int(want["timeslot"][i]), int(want["src_as"][i]),
         int(want["dst_as"][i]), int(want["etype"][i])):
        [int(want["bytes"][i]), int(want["packets"][i]),
         int(want["count"][i])] for i in range(len(want["timeslot"]))}
    tops = [json.loads((outdir / f"top_{pid}.json").read_text())
            for pid in pids]
    assert all(t == tops[0] for t in tops[1:])
    top = tops[0]
    got = {(tuple(top["src_addr"][i]), tuple(top["dst_addr"][i])):
           (int(top["bytes"][i]), int(top["packets"][i]),
            int(top["count"][i]))
           for i in range(len(top["valid"])) if top["valid"][i]}
    pairs = exact_groupby(full, ["src_addr", "dst_addr"])
    n = len(pairs["bytes"])
    src = np.asarray(pairs["src_addr"]).reshape(n, -1)
    dst = np.asarray(pairs["dst_addr"]).reshape(n, -1)
    exact = {(tuple(int(x) for x in src[i]), tuple(int(x) for x in dst[i])):
             (int(pairs["bytes"][i]), int(pairs["packets"][i]),
              int(pairs["count"][i])) for i in range(n)}
    for key, vals in got.items():
        assert exact[key] == vals
    assert set(sorted(exact, key=lambda k: -exact[k][0])[:20]) == set(got)


def test_two_processes_kill_and_resume_oracle_exact(tmp_path):
    script = tmp_path / "e2e.py"
    script.write_text(KILL_RESUME)
    ckpt, outdir = tmp_path / "ckpt", tmp_path / "out"
    ckpt.mkdir()
    outdir.mkdir()
    outs = _run_procs(script, "first", ckpt, outdir, 2, expect_crash=True)
    assert all(f"KILLED {pid}" in out for pid, out in enumerate(outs))
    assert (ckpt / "0").is_dir() and (ckpt / "1").is_dir()
    assert not list(outdir.iterdir())  # crashed before any emission
    outs = _run_procs(script, "resume", ckpt, outdir, 2)
    for pid, out in enumerate(outs):
        assert f"MULTIHOST_E2E_OK {pid}" in out
    _check_against_oracle(outdir, (0, 1), _stream(5, 8, 512))
    # and equal to one process's sharded model at the same N over the
    # same global batches
    one = ShardedHeavyHitter(HeavyHitterConfig(
        key_cols=("src_addr", "dst_addr"), batch_size=128, width=1 << 10,
        capacity=64), make_mesh(4, devices="cpu"))
    gen = FlowGenerator(ZipfProfile(n_keys=30, alpha=1.4), seed=5, t0=9000)
    for _ in range(8):
        one.update(gen.batch(512))
    want = json.loads(json.dumps({k: np.asarray(v).tolist()
                                  for k, v in one.top(20).items()}))
    assert json.loads((outdir / "top_0.json").read_text()) == want


# ---- four processes, one lost for good -------------------------------------------

REBALANCE = _PRELUDE + _STREAM + textwrap.dedent("""
    N_PARTS, PER, N_BATCHES, SNAP_AT = 4, 128, 8, 3
    mesh = make_mesh(nprocs)  # one shard per process
    pipe = pipeline(mesh, PER)
    # every process derives the same global stream; partition p is the
    # p-th contiguous row quarter of each global batch
    gen = FlowGenerator(ZipfProfile(n_keys=30, alpha=1.4), seed=11, t0=9000)
    batches = [gen.batch(PER * N_PARTS) for _ in range(N_BATCHES)]
    def part_slice(b, part):
        cols = batches[b].device_columns(COLS)
        sl = slice(part * PER, (part + 1) * PER)
        return {k: np.ascontiguousarray(v[sl]) for k, v in cols.items()}
    # no flush until the final forced one: the watermark may be eager
    wm = max(int(b.columns["time_received"].max()) for b in batches)
    if phase == "first":
        # processes 0-2 snapshot after SNAP_AT batches; process 3 is then
        # lost with NOTHING durable: its committed offset stays 0
        for b in range(SNAP_AT):
            pipe.update(part_slice(b, pid), np.ones(PER, bool), wm)
        if pid != 3:
            pipe.snapshot(os.path.join(ckpt, str(pid)))
        dist.barrier()
        print("SNAPSHOT_DONE", pid, flush=True)
        if pid == 3:
            print("LOST", pid, flush=True)
            os._exit(0)
        dist.destroy_process_group()
        sys.exit(0)
    # rebalance: the 3 survivors form a NEW world, restore their own
    # state and re-consume the lost partition from its committed offset,
    # round-robined by the pure reassignment each computes alone
    start = pipe.restore(os.path.join(ckpt, str(pid)))
    assert start == SNAP_AT, start
    survivors = list(range(nprocs))
    assign = reassign_lost_partitions({3: 0}, survivors, N_BATCHES)
    work = {s: [(s, b) for b in range(SNAP_AT, N_BATCHES)] + assign[s]
            for s in survivors}
    zero = {k: np.zeros_like(v) for k, v in part_slice(0, 0).items()}
    for r in range(max(len(w) for w in work.values())):
        if r < len(work[pid]):
            part, b = work[pid][r]
            pipe.update(part_slice(b, part), np.ones(PER, bool), wm)
        else:  # an all-invalid round keeps every process in step
            pipe.update(zero, np.zeros(PER, bool), wm)
    emit(pipe.flush(force=True))
    print("REBALANCE_OK", pid, flush=True)
    dist.destroy_process_group()
""")


def test_survivors_reconsume_a_lost_partition(tmp_path):
    script = tmp_path / "loss.py"
    script.write_text(REBALANCE)
    ckpt, outdir = tmp_path / "ckpt", tmp_path / "out"
    ckpt.mkdir()
    outdir.mkdir()
    outs = _run_procs(script, "first", ckpt, outdir, 4, expect_crash=True)
    assert any("LOST 3" in out for out in outs)
    assert all((ckpt / str(pid)).is_dir() for pid in (0, 1, 2))
    assert not (ckpt / "3").exists()  # the lost process left nothing
    outs = _run_procs(script, "rebalance", ckpt, outdir, 3)
    for pid, out in enumerate(outs):
        assert f"REBALANCE_OK {pid}" in out
    # nothing lost with the dead process, nothing counted twice
    _check_against_oracle(outdir, (0, 1, 2), _stream(11, 8, 512))

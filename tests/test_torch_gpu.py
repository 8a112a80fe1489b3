"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs. Conservative update: tolerance none (the
atomicMax scatter is order-free, so the kernel is bit-exact). Linear
update: tolerance none with integer addends whose cell totals stay below
2^24 (every partial sum is exact, so atomic order cannot show); rtol 1e-6
with real-valued addends (float32 atomic adds in run-to-run order).

Marked ``gpu``: run with ``python -m pytest -m gpu tests/test_torch_gpu.py``
on a machine with a card. Whether a card is present is decided inside
each test, so every worker collects the same tests; without one they
skip with the reason.
"""

import numpy as np
import pytest
import torch

from flow_pipeline_tpu_torch import kernels
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.ops import cms as tcms
from flow_pipeline_tpu_torch.ops import cms_cuda

pytestmark = pytest.mark.gpu


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


@pytest.mark.parametrize("wk,key_dtype", [(11, torch.int64), (4, torch.int64),
                                          (4, torch.int32)])
def test_conservative_kernel_matches_plain(wk, key_dtype):
    _require_cuda()
    rng = np.random.default_rng(wk)
    p, d, w, n = 3, 4, 65536, 32768
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    ref = counts.clone()
    before = cms_cuda.LAUNCHES["cms_add_conservative"]
    for _ in range(3):
        keys_np = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
        keys_np = np.unique(keys_np, axis=0)  # the update's contract
        keys = torch.from_numpy(keys_np.astype(np.int64) if key_dtype ==
                                torch.int64 else keys_np.view(np.int32))
        keys = keys.cuda()
        m = keys.shape[0]
        vals = torch.from_numpy(
            rng.integers(0, 1500, size=(m, p)).astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(m) < 0.8).cuda()
        cms_cuda.cms_add_conservative(counts, keys, vals, valid)
        tcms.cms_add_conservative(ref, keys, vals, valid)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref)
    assert cms_cuda.LAUNCHES["cms_add_conservative"] == before + 3


@pytest.mark.parametrize("wk,key_dtype", [(11, torch.int64), (4, torch.int64),
                                          (4, torch.int32)])
def test_linear_kernel_matches_plain(wk, key_dtype):
    _require_cuda()
    rng = np.random.default_rng(100 + wk)
    p, d, w, n = 3, 4, 65536, 32768
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    ref = counts.clone()
    before = dict(cms_cuda.LAUNCHES)
    for real in (False, False, True):
        keys_np = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
        keys = torch.from_numpy(keys_np.astype(np.int64) if key_dtype ==
                                torch.int64 else keys_np.view(np.int32))
        keys = keys.cuda()
        vals_np = (rng.random((n, p)) * 1e4 if real
                   else rng.integers(0, 1500, size=(n, p)))
        vals = torch.from_numpy(vals_np.astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(n) < 0.8).cuda()
        cms_cuda.cms_add(counts, keys, vals, valid)
        tcms.cms_add(ref, keys, vals, valid)
        torch.cuda.synchronize()
        if real:  # float32 atomic order
            torch.testing.assert_close(counts, ref, rtol=1e-6, atol=0)
        else:  # integer cells below 2^24: exact in any order
            assert counts.max().item() < 2**24
            assert torch.equal(counts, ref)
    assert cms_cuda.LAUNCHES["cms_add"] == before["cms_add"] + 3
    assert (cms_cuda.LAUNCHES["cms_add_conservative"]
            == before["cms_add_conservative"])


def _unique_keys(rng, n, wk):
    keys = np.unique(rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32),
                     axis=0)
    return keys[rng.permutation(len(keys))]


def _update_case(rng, n, wk, p=3, d=4, w=65536):
    """Integer cells and addends (every cell stays below 2^24, so the
    linear kernel is exact in any atomic order), 80 % valid rows."""
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    keys = torch.from_numpy(_unique_keys(rng, n, wk).astype(np.int64)).cuda()
    m = keys.shape[0]
    vals = torch.from_numpy(
        rng.integers(0, 1500, size=(m, p)).astype(np.float32)).cuda()
    valid = torch.from_numpy(rng.random(m) < 0.8).cuda()
    return counts, keys, vals, valid


_PLAIN = {"cms_add_conservative": tcms.cms_add_conservative,
          "cms_add": tcms.cms_add}


@pytest.mark.parametrize("kernel", ["cms_add_conservative", "cms_add"])
@pytest.mark.parametrize("n,wk", [(32768, 11), (1 << 19, 4)],
                         ids=["registers", "scratch"])
def test_estimate_form_matches_update_then_query(kernel, n, wk):
    """The estimate form equals the plain update followed by cms_query,
    over three calls on one sketch, on the register route (N = 32,768)
    and on the scratch route (N above the resident threads)."""
    _require_cuda()
    rng = np.random.default_rng(200 + wk)
    counts, keys, vals, valid = _update_case(rng, n, wk)
    resident = cms_cuda._resident_rows(kernels.library(), kernel,
                                       counts.device.index, wk, 4, 3)
    assert (keys.shape[0] > resident) == (n > 32768)
    ref = counts.clone()
    before = cms_cuda.LAUNCHES[kernel]
    for _ in range(3):
        _, est = getattr(cms_cuda, kernel)(counts, keys, vals, valid,
                                           with_estimate=True)
        _PLAIN[kernel](ref, keys, vals, valid)
        torch.cuda.synchronize()
        assert counts.max().item() < 2**24
        assert torch.equal(counts, ref)
        assert torch.equal(est, tcms.cms_query(ref, keys))
    assert cms_cuda.LAUNCHES[kernel] == before + 3


@pytest.mark.parametrize("kernel", ["cms_add_conservative", "cms_add"])
def test_one_device_launch_per_call(kernel):
    """Each wrapper call, either form, is one kernel on the card.

    The card's CUPTI tracing drops events now and then (a cycle's first
    kernel, or a whole cycle), so five warm cycles of the same four calls
    are profiled, each after a warm-up cycle thrown away: every cycle
    that recorded the kernel may hold at most four launches (one per
    call), at least one cycle must hold all four, and no recorded event
    may be another kernel. A run that records nothing fails."""
    _require_cuda()
    from torch.profiler import ProfilerActivity, profile, schedule

    counts, keys, vals, valid = _update_case(np.random.default_rng(5),
                                             32768, 11)
    fn = getattr(cms_cuda, kernel)
    fn(counts, keys, vals, valid, with_estimate=True)
    torch.cuda.synchronize()
    cycles = []

    def ready(p):
        cycles.append([e.name for e in p.events()
                       if str(e.device_type).endswith("CUDA")])

    repeat = 5
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=repeat),
                 on_trace_ready=ready) as prof:
        for _ in range(2 * repeat):  # warm-up and measured, in turns
            for est in (False, True, False, True):
                fn(counts, keys, vals, valid, with_estimate=est)
            torch.cuda.synchronize()
            prof.step()
    recorded = [c for c in cycles if c]
    assert recorded, f"no profiled cycle recorded a kernel: {cycles}"
    assert all(len(c) <= 4 for c in recorded), cycles
    assert any(len(c) == 4 for c in recorded), cycles
    assert all("fpt_cms" in name for c in recorded for name in c), cycles


def test_cooperative_launch_error_raises(monkeypatch):
    """A register-route grid larger than the card holds is refused by the
    cooperative launch; the wrapper raises and counts no launch, and the
    next call works."""
    _require_cuda()
    counts, keys, vals, valid = _update_case(np.random.default_rng(6),
                                             1 << 19, 4)
    key = ("cms_add_conservative", counts.device.index, 4, 4, 3)
    monkeypatch.setitem(cms_cuda._resident, key, 1 << 30)  # no scratch
    before = cms_cuda.LAUNCHES["cms_add_conservative"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cms_cuda.cms_add_conservative(counts, keys, vals, valid)
    assert cms_cuda.LAUNCHES["cms_add_conservative"] == before
    monkeypatch.undo()
    ref = counts.clone()
    cms_cuda.cms_add_conservative(counts, keys, vals, valid)
    tcms.cms_add_conservative(ref, keys, vals, valid)
    torch.cuda.synchronize()
    assert torch.equal(counts, ref)


def test_generic_shape_and_unaligned_keys():
    """The generic instantiation (D = 3, P = 2, Wk = 3 at run time) on
    int32 keys whose slabs start 12 bytes past an aligned address (staged
    by plain loads, not the TMA bulk copy) and a ragged last tile equals
    the plain versions."""
    _require_cuda()
    rng = np.random.default_rng(7)
    n, wk, p, d, w = 1000, 3, 2, 3, 4096
    raw = _unique_keys(rng, n + 1, wk)[: n + 1]
    keys = torch.from_numpy(raw.view(np.int32)).cuda()[1:]
    assert keys.is_contiguous() and keys.data_ptr() % 16 == 12
    m = keys.shape[0]
    for kernel in ("cms_add_conservative", "cms_add"):
        counts = torch.from_numpy(
            rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
        ref = counts.clone()
        vals = torch.from_numpy(
            rng.integers(0, 1500, size=(m, p)).astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(m) < 0.8).cuda()
        _, est = getattr(cms_cuda, kernel)(counts, keys, vals, valid,
                                           with_estimate=True)
        _PLAIN[kernel](ref, keys, vals, valid)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref), kernel
        assert torch.equal(est, tcms.cms_query(ref, keys)), kernel


def test_full_model_set_on_card_matches_cpu():
    """flows_5m, a port table and the DDoS detector on the card give the
    CPU's rows and alerts exactly (integer planes; DDoS rates below
    2^24)."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.models import (DDoSConfig, DDoSDetector,
                                                DenseTopConfig,
                                                DenseTopKModel,
                                                WindowAggConfig,
                                                WindowAggregator)

    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=2, rate=200.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        wagg = WindowAggregator(WindowAggConfig(batch_size=4096), device=dev)
        ports = WindowedHeavyHitter(DenseTopConfig(batch_size=4096), k=50,
                                    model_cls=DenseTopKModel, device=dev)
        ddos = DDoSDetector(DDoSConfig(batch_size=4096, warmup_windows=1),
                            device=dev)
        for b in batches:
            for m in (wagg, ports, ddos):
                m.update(b)
        ddos.close_sub_window()
        out[dev] = (wagg.flush(force=True), ports.flush(force=True),
                    ddos.alerts)
    (gw, gp, ga), (cw, cp, ca) = out["cuda"], out["cpu"]
    for name in cw:
        np.testing.assert_array_equal(gw[name], cw[name], err_msg=name)
    for g, c in zip(gp, cp):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    assert len(ga) == len(ca)
    for g, c in zip(ga, ca):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)


def test_model_on_card_matches_cpu():
    _require_cuda()
    cfg = thh.HeavyHitterConfig(key_cols=("src_addr", "dst_addr"),
                                batch_size=4096, width=8192, capacity=64)
    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=1, rate=1000.0)
    cpu = thh.HeavyHitterModel(cfg, device="cpu")
    gpu = thh.HeavyHitterModel(cfg, device="cuda")
    for _ in range(3):
        batch = gen.batch(5000)
        cpu.update(batch)
        gpu.update(batch)
    got, want = gpu.top(), cpu.top()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _default_models(dev, bs=4096, conservative=True):
    """The processor's default model set at a small width, on ``dev``."""
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.models import (DDoSConfig, DDoSDetector,
                                                DenseTopConfig,
                                                DenseTopKModel,
                                                WindowAggConfig,
                                                WindowAggregator)

    def hh(keys):
        return WindowedHeavyHitter(thh.HeavyHitterConfig(
            key_cols=keys, batch_size=bs, width=8192, capacity=64,
            conservative=conservative), k=50, device=dev)

    return {
        "flows_5m": WindowAggregator(WindowAggConfig(batch_size=bs),
                                     device=dev),
        "top_talkers": hh(("src_addr", "dst_addr", "src_port", "dst_port",
                           "proto")),
        "top_src_ips": hh(("src_addr",)),
        "top_dst_ips": hh(("dst_addr",)),
        "top_src_ports": WindowedHeavyHitter(
            DenseTopConfig(key_col="src_port", batch_size=bs), k=50,
            model_cls=DenseTopKModel, device=dev),
        "ddos_alerts": DDoSDetector(DDoSConfig(batch_size=bs,
                                               warmup_windows=1),
                                    device=dev),
    }


@pytest.mark.parametrize("conservative", [True, False],
                         ids=["conservative", "linear"])
def test_fused_pipeline_on_card_matches_cpu(conservative):
    """The fused pipeline over batches that cross sub-windows and a
    window slot, on the card and the CPU: every flushed row and alert
    equal (integer-valued sums below 2^24, so atomic order cannot show),
    and on the card one CMS launch per family per fused step, of the
    family's kind."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine import FusedPipeline

    kernel = "cms_add_conservative" if conservative else "cms_add"
    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=3, rate=40.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        models = _default_models(dev, conservative=conservative)
        pipe = FusedPipeline(models)
        before = dict(cms_cuda.LAUNCHES)
        for b in batches:
            pipe.update(b)
        torch.cuda.synchronize()
        steps = models["top_talkers"].model.chunk_updates
        launched = {k: v - before[k] for k, v in cms_cuda.LAUNCHES.items()}
        want = {k: 0 for k in launched}
        if dev == "cuda":
            want[kernel] = 3 * steps
        assert launched == want
        models["ddos_alerts"].close_sub_window()
        out[dev] = {n: (m.flush(True) if not hasattr(m, "alerts")
                        else m.alerts) for n, m in models.items()}
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if isinstance(want, dict):  # flows_5m
            want, got = [want], [got]
        assert len(got) == len(want), name
        for g, c in zip(got, want):
            for col in c:
                np.testing.assert_array_equal(g[col], c[col],
                                              err_msg=f"{name} {col}")


def test_fused_step_on_card_matches_cpu_at_full_width():
    """One fused step at the processor's full width (batch 32,768, CMS
    width 65,536, depth 4, capacity 1,024, 65,536-port tables, 16,384
    DDoS buckets) from the same zero states: CMS counters, tables, dense
    totals, DDoS state and the flows_5m partial equal on the card and the
    CPU."""
    _require_cuda()
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import FusedPipeline

    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(["-in", "unused"])
    gen = FlowGenerator(ZipfProfile(), seed=0, rate=500.0)
    chunk, mask = gen.batch(30000).pad_to(32768)
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = FusedPipeline(cli._build_models(vals, dev))
        host = chunk.device_columns(pipe._cols)
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in host.items()}
        valid = torch.from_numpy(mask).to(dev)
        states = (tuple(w.model.state for _, w in pipe._hh),
                  tuple(w.model.totals for _, w in pipe._dense),
                  tuple(d.state for _, d in pipe._ddos))
        outs[dev] = pipe._step(states, cols, valid, valid, valid)
        torch.cuda.synchronize()
    (gs, gw), (cs, cw) = outs["cuda"], outs["cpu"]
    flat_g = [t for group in gs for st in group
              for t in (st if isinstance(st, tuple) else (st,))]
    flat_c = [t for group in cs for st in group
              for t in (st if isinstance(st, tuple) else (st,))]
    assert len(flat_g) == len(flat_c) == 3 * 3 + 2 + 7
    for g, c in zip(flat_g, flat_c):
        if c.dtype == torch.float32:
            assert c.abs().max().item() < 2**24
        assert torch.equal(g.cpu(), c)
    for g, c in zip(gw[0], cw[0]):
        assert torch.equal(g.cpu(), c)


def _ckpt_worker(device, batches, ckpt=None):
    """A StreamWorker with the default model set at narrow widths on
    ``device`` over pre-decoded batches (polled inline)."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import StreamWorker

    class Batches:
        def __init__(self, items):
            self._it = iter(items)

        def poll(self, max_messages):
            return next(self._it, None)

        def commit(self, partition, next_offset):
            pass

    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(
            ["-in", "unused", "-processor.batch", "4096", "-sketch.width",
             "8192", "-sketch.capacity", "256"])
    return StreamWorker(Batches(batches), cli._build_models(vals, device),
                        poll_max=4096, prefetch=0, host_assist="off",
                        checkpoint_path=None if ckpt is None else str(ckpt))


def _ckpt_stream():
    gen = FlowGenerator(ZipfProfile(), seed=4, rate=100.0)
    return [gen.batch(4096) for _ in range(6)]


def _device_tensors(worker):
    from flow_pipeline_tpu_torch.models import DDoSDetector

    for m in worker.models.values():
        if isinstance(m, DDoSDetector):
            yield from m.state
        elif hasattr(m, "model"):
            inner = m.model
            yield from (inner.state if hasattr(inner, "state")
                        else (inner.totals,))


def _state_equal(a, b) -> bool:
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return all(_state_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("n,wk", [(1024, 11), (4096, 4), (32768, 11),
                                  (32768, 4)])
def test_conservative_kernel_at_hostgroup_buckets(n, wk):
    """The host-grouped pipeline's shapes: group tables padded to a power
    of two (1,024 ... 32,768 rows) with real groups first and padding
    rows invalid; the estimate form equals the plain update followed by
    cms_query (torch.equal)."""
    _require_cuda()
    rng = np.random.default_rng(n + wk)
    p, d, w = 3, 4, 65536
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    ref = counts.clone()
    for g in (n // 2 + 1, n):
        keys_np = np.zeros((n, wk), np.uint32)
        keys_np[:g] = np.unique(rng.integers(0, 2**32, (g, wk),
                                             dtype=np.uint32), axis=0)[:g]
        keys = torch.from_numpy(keys_np.astype(np.int64)).cuda()
        vals = torch.zeros((n, p), dtype=torch.float32, device="cuda")
        vals[:g] = torch.from_numpy(
            rng.integers(1, 1500, (g, p)).astype(np.float32)).cuda()
        valid = torch.arange(n, device="cuda") < g
        _, est = cms_cuda.cms_add_conservative(counts, keys, vals, valid,
                                               with_estimate=True)
        tcms.cms_add_conservative(ref, keys, vals, valid)
        want = tcms.cms_query(ref, keys)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref) and torch.equal(est, want)


def test_hostgroup_pipeline_on_card_matches_cpu():
    """The host-grouped pipeline with the spread detectors, on the card
    and the CPU: every flushed row and alert equal; on the card one
    conservative launch per family per applied chunk, each at a
    power-of-two group-table shape."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline
    from flow_pipeline_tpu_torch.models import scan, superspreader

    gen = FlowGenerator(ZipfProfile(n_keys=2000, spread_fraction=0.05),
                        seed=3, rate=40.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out, shapes = {}, []
    orig = cms_cuda._launch

    def seen(name, counts, keys, *a):
        shapes.append(keys.shape[0])
        return orig(name, counts, keys, *a)

    for dev in ("cuda", "cpu"):
        models = _default_models(dev, conservative=True)
        models["superspreaders"] = superspreader.superspreader_model(
            superspreader.superspreader_config(batch_size=4096), device=dev)
        models["portscan"] = scan.scan_model(
            scan.scan_config(batch_size=4096), device=dev)
        pipe = HostGroupPipeline(models, native_group=True)
        before = dict(cms_cuda.LAUNCHES)
        cms_cuda._launch = seen
        try:
            for b in batches:
                pipe.apply(pipe.prepare(b))
        finally:
            cms_cuda._launch = orig
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in cms_cuda.LAUNCHES.items()}
        want = {k: 0 for k in launched}
        if dev == "cuda":
            want["cms_add_conservative"] = 3 * pipe.applied_chunks
        assert launched == want
        models["ddos_alerts"].close_sub_window()
        out[dev] = {n: (m.flush(True) if not hasattr(m, "alerts")
                        else m.alerts) for n, m in models.items()}
    assert shapes and all(s >= 1024 and s & (s - 1) == 0 for s in shapes)
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if isinstance(want, dict):  # flows_5m
            want, got = [want], [got]
        assert len(got) == len(want), name
        for g, c in zip(got, want):
            for col in c:
                np.testing.assert_array_equal(g[col], c[col],
                                              err_msg=f"{name} {col}")


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_host_sketch_pipeline_on_card_matches_cpu(fused):
    """The host sketch pipeline (the heavy-hitter families on the host
    engine, top_src_ips and top_dst_ips invertible, the rest-step on the
    models' device), on the card and the CPU: every flushed row and alert
    equal; no CMS kernel launched; the table family's exported state on
    the card."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline

    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=5, rate=40.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        models = _default_models(dev)
        for name in ("top_src_ips", "top_dst_ips"):
            cfg = models[name].config
            models[name] = WindowedHeavyHitter(thh.HeavyHitterConfig(**{
                **cfg.__dict__, "hh_sketch": "invertible"}), k=50,
                device=dev)
        pipe = HostSketchPipeline(models, native_group=True, fused=fused)
        before = dict(cms_cuda.LAUNCHES)
        for b in batches:
            pipe.apply(pipe.prepare(b))
        pipe.sync_states()
        torch.cuda.synchronize()
        assert cms_cuda.LAUNCHES == before
        assert pipe.rest_steps > 0
        assert models["top_talkers"].model.state.cms.device.type == dev
        models["ddos_alerts"].close_sub_window()
        out[dev] = {n: (m.flush(True) if not hasattr(m, "alerts")
                        else m.alerts) for n, m in models.items()}
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if isinstance(want, dict):  # flows_5m
            want, got = [want], [got]
        assert len(got) == len(want), name
        for g, c in zip(got, want):
            for col in c:
                np.testing.assert_array_equal(g[col], c[col],
                                              err_msg=f"{name} {col}")


@pytest.mark.parametrize("writer", ["cuda", "cpu"])
def test_checkpoint_restores_card_state(tmp_path, writer):
    """A worker on ``writer`` runs 3 batches and saves; a fresh worker on
    the card restores the checkpoint. Its state is on the card and equal
    to the saved one; then both finish the stream (the writer, and the
    restored card worker) and their states stay equal (integer sums
    inside 2^24: the kernels are exact)."""
    _require_cuda()
    batches = _ckpt_stream()
    first = _ckpt_worker(writer, batches, tmp_path / "ckpt")
    for _ in range(3):
        assert first.run_once()
    first.snapshot_and_commit()
    saved = first._state()
    card = _ckpt_worker("cuda", batches[3:], tmp_path / "ckpt")
    assert card.restore()
    assert all(t.device.type == "cuda" for t in _device_tensors(card))
    assert _state_equal(card._state(), saved)
    while first.run_once():
        pass
    while card.run_once():
        pass
    torch.cuda.synchronize()
    assert first.flows_seen == card.flows_seen == 6 * 4096
    assert _state_equal(card._state(), first._state())


def snapshot_estimate_held(device):
    """Publish a snapshot after one batch, run two more batches of the
    same window (the CMS update writes the same ``HHState.cms`` tensor in
    place), then query the snapshot's ``/query/estimate`` for the top
    key: it must equal the estimate of the planes as they were at the
    publish, while the live planes moved on. Returns the CMS launches
    of the run."""
    import json
    import urllib.request

    from flow_pipeline_tpu_torch.engine import StreamWorker
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.hostsketch.engine import np_cms_query_u64
    from flow_pipeline_tpu_torch.hostsketch.state import frozen_cms
    from flow_pipeline_tpu_torch.schema import wire
    from flow_pipeline_tpu_torch.serve import ServeServer, attach_worker
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

    gen = FlowGenerator(ZipfProfile(n_keys=500), seed=5, rate=100_000.0)
    bus = InProcessBus()
    bus.create_topic("flows", 1)
    bus.produce_many("flows", wire.iter_raw_frames(gen.batch(3 * 4096)
                                                   .to_wire()))
    model = WindowedHeavyHitter(thh.HeavyHitterConfig(
        batch_size=4096, capacity=64), k=20, device=device)
    worker = StreamWorker(Consumer(bus), {"top_talkers": model}, [],
                          poll_max=4096, prefetch=0, snapshot_every=0)
    pub = attach_worker(worker, refresh=0.0)
    launches = cms_cuda.LAUNCHES["cms_add_conservative"]
    assert worker.run_once()
    snap = pub.store.current
    planes = model.model.state.cms
    held = planes.detach().cpu().numpy().copy()  # as at the publish
    fam = snap.families["top_talkers"]
    lanes = [int(x) for col in model.config.key_cols
             for x in np.atleast_1d(fam.rows[col][0])]
    serve = ServeServer(pub.store, port=0).start()
    try:
        assert worker.run_once() and worker.run_once()
        assert model.model.state.cms is planes  # updated in place
        assert model.current_slot == fam.window_start  # the same window
        key = ",".join(map(str, lanes))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{serve.port}/query/estimate?key={key}",
                timeout=10) as resp:
            doc = json.loads(resp.read())
    finally:
        serve.stop()
    keys = np.asarray([lanes], np.uint32)
    want = np_cms_query_u64(frozen_cms(held), keys)[0]
    live = np_cms_query_u64(frozen_cms(planes), keys)[0]
    assert doc["version"] == 1 == pub.store.current.version
    assert list(doc["estimates"].values()) == [int(x) for x in want]
    assert (live > want).all()  # the later batches did count this key
    return cms_cuda.LAUNCHES["cms_add_conservative"] - launches


def test_snapshot_survives_in_place_updates_on_card():
    """A snapshot published on the card keeps answering /query/estimate
    from the planes as they were at its publish while the conservative
    kernel goes on updating the same tensor in place."""
    _require_cuda()
    assert snapshot_estimate_held("cuda") > 0


GUARD_BUDGET = 1.0  # -guard.lag: the hysteresis band is [0.5, 1.0] s


def force_level(guard, level):
    """Step a guard's ladder to ``level`` with explicit clocks, then hold
    it: every later observe is fed a lag inside the hysteresis band, so
    neither wall time nor the stream's real lag moves it."""
    for i in range(level):
        assert guard.observe(10.0, now=10.0 * (i + 1)) == i + 1
    observe = guard.observe
    guard.observe = lambda lag, now=None: observe(0.75 * GUARD_BUDGET, now)


def guarded_rows(device, level, tmp_path, flags=()):
    """``processor`` at small widths on a seeded Zipf frames file with
    ``-guard.lag`` armed and the ladder held at ``level`` on ``device``.
    Returns (sorted sqlite rows per table, the worker, the conservative
    launches of the run)."""
    import sqlite3

    from flow_pipeline_tpu_torch import cli

    frames = tmp_path / "guard-frames.bin"
    if not frames.exists():
        assert cli.main(["mocker", "-out", str(frames), "-produce.profile",
                         "zipf", "-produce.count", "8000",
                         "-produce.rate", "400", "-produce.seed", "7"]) == 0
    db = tmp_path / f"guard-{device}-{level}.db"
    before = cms_cuda.LAUNCHES["cms_add_conservative"]
    worker = cli.run_processor(
        ["-device", device, "-in", str(frames), "-sink", f"sqlite:{db}",
         "-processor.batch", "4096", "-sketch.width", "8192",
         "-metrics.addr", "", "-loglevel", "warning", "-guard.lag",
         str(GUARD_BUDGET), *flags],
        on_start=lambda w, services: force_level(w.guard, level))
    if device == "cuda":
        torch.cuda.synchronize()
    conn = sqlite3.connect(db)
    try:
        rows = {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                          key=repr)
                for t in ("flows_5m", "top_talkers", "top_src_ips",
                          "top_dst_ips", "top_src_ports", "top_dst_ports",
                          "ddos_alerts")}
    finally:
        conn.close()
    return rows, worker, cms_cuda.LAUNCHES["cms_add_conservative"] - before


@pytest.mark.parametrize("level,flags", [
    (3, ("-processor.hostassist", "off")),
    (2, ("-processor.hostassist", "on")),
    (1, ("-processor.hostassist", "on")),
], ids=["fused-L3", "hostgroup-L2", "hostgroup-L1"])
def test_guarded_run_on_card_matches_cpu(tmp_path, level, flags):
    """A guarded processor held at a forced level on the card: the seven
    tables equal the same run's on the CPU, the same rows are shed, and
    the conservative kernel ran once per family chunk update."""
    _require_cuda()
    card, cw, launches = guarded_rows("cuda", level, tmp_path, flags)
    cpu, pw, _ = guarded_rows("cpu", level, tmp_path, flags)
    assert cw.guard.meta() == pw.guard.meta()
    assert (cw.guard.meta()["shed_total"] > 0) == (level >= 2)
    assert cw.flows_seen == pw.flows_seen
    assert launches == cw.chunk_updates > 0
    for table, want in cpu.items():
        assert card[table] == want, table


def _mesh_rows(device, tmp_path):
    """``pipeline -mesh.workers 2`` on ``device``: the seven tables, the
    devices of every model set the members built, the conservative
    kernel's launches and the process tally of CMS updates."""
    import sqlite3

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine.fused import state_device

    db = tmp_path / f"mesh-{device}.db"
    devices = set()

    def on_start(mesh, services):
        for m in mesh.members:
            def built(make=m.model_factory):
                models = make()
                devices.add(state_device(models).type)
                return models
            m.model_factory = built

    before = (cms_cuda.LAUNCHES["cms_add_conservative"],
              thh.CHUNK_UPDATES["cms_add_conservative"])
    cli.run_pipeline(
        ["-mesh.workers", "2", "-device", device, "-produce.count", "20000",
         "-produce.rate", "100", "-produce.profile", "zipf",
         "-processor.hostassist", "off", "-processor.batch", "4096",
         "-sketch.width", "8192", "-metrics.addr", "", "-loglevel",
         "warning", "-mesh.heartbeat", "3600", "-sink", f"sqlite:{db}"],
        on_start=on_start)
    if device == "cuda":
        torch.cuda.synchronize()
    conn = sqlite3.connect(db)
    try:
        rows = {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                          key=repr)
                for t in ("flows_5m", "top_talkers", "top_src_ips",
                          "top_dst_ips", "top_src_ports", "top_dst_ports",
                          "ddos_alerts")}
    finally:
        conn.close()
    return (rows, devices,
            cms_cuda.LAUNCHES["cms_add_conservative"] - before[0],
            thh.CHUNK_UPDATES["cms_add_conservative"] - before[1])


def test_mesh_on_card_matches_cpu(tmp_path):
    """Two mesh members stepping their fused steps on the card from two
    threads: every launch counted (launches == the members' CMS updates),
    every member's state on the card, and the merged tables equal the
    same mesh's on the CPU."""
    _require_cuda()
    card, card_devs, launches, updates = _mesh_rows("cuda", tmp_path)
    cpu, cpu_devs, _, _ = _mesh_rows("cpu", tmp_path)
    assert card_devs == {"cuda"} and cpu_devs == {"cpu"}
    assert launches == updates > 0
    for table, want in cpu.items():
        assert card[table] == want, table


def test_sharded_models_on_card_match_cpu():
    """Four shards of every sharded model on the card (one card holds
    them all): one launch per shard per chunk, every shard's state on the
    card, and the merged rows equal the same mesh's on the CPU
    (flows_5m, port tables and alerts exactly; heavy-hitter keys equal,
    values within rtol 1e-6)."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.models import (DDoSConfig, DenseTopConfig,
                                                HeavyHitterConfig,
                                                WindowAggConfig)
    from flow_pipeline_tpu_torch.parallel import (ShardedDDoSDetector,
                                                  ShardedDenseTopK,
                                                  ShardedHeavyHitter,
                                                  ShardedWindowAggregator,
                                                  make_mesh)

    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=4, rate=200.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(4, devices=dev)
        wagg = ShardedWindowAggregator(WindowAggConfig(batch_size=1024), mesh)
        hh = WindowedHeavyHitter(HeavyHitterConfig(batch_size=1024),
                                 k=50, model_cls=ShardedHeavyHitter,
                                 mesh=mesh)
        ports = WindowedHeavyHitter(DenseTopConfig(batch_size=1024), k=50,
                                    model_cls=ShardedDenseTopK, mesh=mesh)
        ddos = ShardedDDoSDetector(DDoSConfig(batch_size=1024,
                                              warmup_windows=1), mesh)
        before = cms_cuda.LAUNCHES["cms_add_conservative"]
        for b in batches:
            for m in (wagg, hh, ports, ddos):
                m.update(b)
        ddos.close_sub_window()
        launched = cms_cuda.LAUNCHES["cms_add_conservative"] - before
        devices = {t.device.type for s in hh.model.states for t in s}
        out[dev] = (wagg.flush(force=True), hh.flush(force=True),
                    ports.flush(force=True), ddos.alerts, launched,
                    hh.model.chunk_updates, devices)
    (gw, gh, gp, ga, glaunch, gupd, gdev) = out["cuda"]
    (cw, ch, cp, ca, claunch, _, cdev) = out["cpu"]
    assert glaunch == gupd > 0 and claunch == 0
    assert gdev == {"cuda"} and cdev == {"cpu"}
    for name in cw:
        np.testing.assert_array_equal(gw[name], cw[name], err_msg=name)
    for g, c in zip(gp, cp):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    for g, c in zip(gh, ch):
        for name in ("src_addr", "dst_addr", "valid", "timeslot"):
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)
        for name in ("bytes", "packets", "count", "bytes_est"):
            np.testing.assert_allclose(g[name], c[name], rtol=1e-6, atol=0,
                                       err_msg=name)
    assert len(ga) == len(ca)
    for g, c in zip(ga, ca):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)

"""chip_smoke.py's phase 19 (the mesh over HTTP, one process per member)
alone, with what it compares against, on one card:

    python3 tools/mesh_http_check.py

It builds the kernels (phase 2), captures phase 15's single-worker
pipeline, runs phase 18's in-process N = 2 mesh, then phase 19; each
phase prints its seconds. About 4 minutes on an H100."""
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

smi = cs.environment(torch)
import flow_pipeline_tpu_torch  # noqa: E402,F401
cs.OUT.mkdir(parents=True, exist_ok=True)
shutil.rmtree(cs.WORK, ignore_errors=True)
cs.WORK.mkdir(parents=True)
with cs.phase("2 build"):
    cs.build_kernels()
cap = cs.Capture()
with cs.phase("15 single worker"):
    _, launches, gen_s, run_s = cs._pipeline_run(
        torch, ["-metrics.addr", "", "-sink", ""], sinks=[cap])
    cs.log(f"single worker: {cs.PIPE_FLOWS / run_s:.0f} flows/s, launches "
           f"{launches}")
with cs.phase("18 in-process N=2"):
    inproc = cs._mesh_run(torch, 2, cs.Capture())
    cs.log(f"in-process N=2: {inproc['flows_per_s']:.0f} flows/s, peak "
           f"{inproc['peak_bytes']} B")
with cs.phase("19 mesh over HTTP"):
    out = cs.http_mesh_phase(torch, smi, cap.tables, inproc)
print("HTTP_CHECK_OK")

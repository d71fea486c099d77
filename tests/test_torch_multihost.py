"""Two real processes of the port joined through the FEATHERCNN_* env triple
(``parallel.maybe_initialize_distributed``, gloo on the CPU), as
tests/test_multihost.py runs the reference's.

- ``parallel.launch.spawn`` starts two ranks, each joining through the env
  triple: ``broadcast_plan`` gives rank 0's plan (17) on both, and a DP
  forward of ResNet-50 w8a8 (mesh (2, 1), b4 at 64x64, each rank b2)
  gives every rank the global output, equal to the unsharded engine's.
- ``python -m feathercnn_tpu_torch.serve`` started twice with the env
  triple prints ``distributed: process i/2`` and serves (its batch slots
  run once, on plans both processes agree on), and stops on SIGTERM.

Few test items per file (see tests/test_torch_kernels.py for why).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.model_format import save_ftpu
from feathercnn_tpu_torch.models import resnet50
from feathercnn_tpu_torch.models.builder import GraphBuilder
from feathercnn_tpu_torch.parallel import ShardingConfig
from feathercnn_tpu_torch.parallel.launch import free_port, plan_rank, spawn
from feathercnn_tpu_torch.parallel.launch import to_numpy
from feathercnn_tpu_torch.quant import calibrate

ROOT = Path(__file__).resolve().parents[1]


def test_two_process_plan_and_dp_forward(tmp_path):
    g = resnet50(batch=4, with_softmax=False)
    x = np.random.default_rng(7).normal(size=(4, 64, 64, 3)).astype(
        np.float32) * 0.1
    calibrate(g, [x], method="max", device="cpu")
    path = str(tmp_path / "resnet50.ftpu")
    save_ftpu(g, path)
    cfg = EngineConfig(backend="cuda", compute_dtype="bfloat16",
                       quant="w8a8")
    want = to_numpy(Engine(g, cfg, device="cpu")(x))
    ranks = spawn(plan_rank, 2, args=(
        path, cfg.replace(sharding=ShardingConfig(mesh_shape=(2, 1))), x,
        "cpu"))
    for plan, outs in ranks:
        assert plan == 17
        np.testing.assert_array_equal(outs[g.outputs[0]], want)


def test_serve_cli_distributed_start(tmp_path):
    b = GraphBuilder("tiny", seed=2)
    y = b.conv("c1", b.input("data", (1, 8, 8, 3)), 8, 3, pad=1, relu=True)
    y = b.pool("gap", y, 0, mode="AVE", global_pooling=True)
    path = str(tmp_path / "tiny.ftpu")
    save_ftpu(b.finish([b.softmax("prob", b.fc("fc", y, 4))]), path)
    port = free_port()
    cmd = [sys.executable, "-m", "feathercnn_tpu_torch.serve", "--model",
           path, "--device", "cpu", "--dtype", "float32", "--host",
           "127.0.0.1", "--port", "0", "--batch-size", "2"]
    procs = []
    for i in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   FEATHERCNN_COORDINATOR=f"tcp://127.0.0.1:{port}",
                   FEATHERCNN_NUM_PROCESSES="2",
                   FEATHERCNN_PROCESS_ID=str(i))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stderr=subprocess.PIPE, text=True))
    # a start that hangs is killed, which ends the stderr reads below
    watchdog = threading.Timer(90, lambda: [p.kill() for p in procs])
    watchdog.start()
    try:
        for i, proc in enumerate(procs):
            lines = []
            for line in proc.stderr:
                lines.append(line.strip())
                if line.startswith("serving on "):
                    break
            assert f"distributed: process {i}/2" in lines, lines
            assert lines[-1].startswith("serving on 127.0.0.1:"), lines
    finally:
        for proc in procs:
            proc.terminate()
        codes = [proc.wait(timeout=60) for proc in procs]
        watchdog.cancel()
    assert codes == [0, 0], codes

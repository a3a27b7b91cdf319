"""The port's decode benchmark (`run_generate_benchmark`) and its MBU
accounting (`utils/flops.py`) against the JAX package's, on the CPU.

The byte count is arithmetic on shapes and must equal the reference's
exactly; MBU needs the card's HBM bandwidth, which the CPU does not
have, so it is None here (the H100 figure is the data sheet's 3.35
TB/s); a time from this run is a CPU time and is only checked to be
positive.
"""
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jflops = importlib.import_module("mpi_operator_tpu.utils.flops")
jt = importlib.import_module("mpi_operator_tpu.models.transformer")
tflops = importlib.import_module("mpi_operator_tpu_torch.utils.flops")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.lm_benchmark")
ROOT = pathlib.Path(__file__).resolve().parent.parent

#: run_generate_benchmark's return keys in the reference
#: (mpi_operator_tpu/examples/lm_benchmark.py:741-746)
REFERENCE_KEYS = {"decode_tokens_per_sec", "tokens_per_iter", "mbu",
                  "decode_kernel", "decode_bytes_per_step", "wall_seconds"}


@pytest.mark.parametrize("kw", [
    dict(num_params=354_823_168, num_layers=24, num_kv_heads=16,
         head_dim=64, batch=8, avg_len=192.5),
    dict(num_params=1_100_048_384, num_layers=16, num_kv_heads=8,
         head_dim=64, batch=8, avg_len=192.5, kv_cache_bytes=1.0,
         kv_scale_bytes=4.0),
    dict(num_params=1000, num_layers=2, num_kv_heads=2, head_dim=32,
         batch=3, avg_len=7.5, param_bytes=4, kv_cache_bytes=4.0)])
def test_decode_bytes_per_step_equals_the_reference(kw):
    assert tflops.decode_bytes_per_step(**kw) == \
        jflops.decode_bytes_per_step(**kw)


def test_hbm_bandwidth_is_the_h100_data_sheet_and_none_elsewhere():
    assert tflops.device_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tflops.device_hbm_bandwidth("NVIDIA A100-SXM4-80GB") is None
    assert tflops.device_hbm_bandwidth("cpu") is None
    assert tflops.mbu(1e9, 100.0, "cpu") is None
    assert tflops.mbu(3.35e9, 100.0, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(0.1)


@pytest.mark.parametrize("family,kv", [("gpt2", None), ("llama", "int8")])
def test_run_generate_benchmark_on_the_cpu(family, kv):
    """The reference's keys; the dense path on the CPU (decode_kernel
    None); MBU None; the step's bytes from the same arguments the
    reference passes, its parameter count taken from the JAX model of
    the same config."""
    logs = []
    m = bench.run_generate_benchmark(
        size="test", family=family, batch=2, prompt_len=8, new_tokens=4,
        num_iters=2, kv_cache_dtype=kv, device="cpu", log=logs.append)
    assert set(m) == REFERENCE_KEYS
    assert m["mbu"] is None and m["decode_kernel"] is False
    assert m["tokens_per_iter"] == 8
    assert m["decode_tokens_per_sec"] > 0 and m["wall_seconds"] > 0
    jcfg = (jt.gpt2_config if family == "gpt2" else jt.llama_config)(
        "test", kv_cache_dtype=kv, max_len=32)
    shapes = jax.eval_shape(jt.CausalLM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    n = sum(x.size for x in jax.tree.leaves(shapes["params"]))
    int8 = kv == "int8"
    assert m["decode_bytes_per_step"] == jflops.decode_bytes_per_step(
        num_params=n, num_layers=jcfg.num_layers,
        num_kv_heads=jcfg.num_kv_heads or jcfg.num_heads,
        head_dim=jcfg.head_dim, batch=2, avg_len=8 + 5 / 2.0,
        param_bytes=2, kv_cache_bytes=1.0 if int8 else 2.0,
        kv_scale_bytes=4.0 if int8 else 0.0)
    assert any("new tokens/sec" in line for line in logs)


def test_generate_benchmark_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_generate_benchmark(size="test")


def test_cli_runs_bert_moe_and_remat(capsys):
    """The CLI's new flags at test size on the CPU: --workload bert,
    --moe-experts with --moe-dropless, --remat with --remat-policy;
    each exits 0 with its headline line."""
    common = ["--size", "test", "--batch-per-device", "2", "--seq-len",
              "16", "--dtype", "float32", "--warmup-steps", "1",
              "--num-steps", "2", "--device", "cpu"]
    for extra, metric in ((["--workload", "bert"], "bert_tokens_per_sec"),
                          (["--moe-experts", "4", "--moe-dropless"],
                           "gpt2_tokens_per_sec"),
                          (["--workload", "bert", "--remat",
                            "--remat-policy", "dots"],
                           "bert_tokens_per_sec")):
        assert bench.main(common + extra) == 0
        assert f'"metric": "{metric}"' in capsys.readouterr().out


@pytest.mark.parametrize("flags,step", [
    (["--tp", "2"], "1 devices not divisible by tp=2"),
    # the id this case had while --pp was refused as step 10d
    pytest.param(["--pp", "2"], "1 devices not divisible by pp=2",
                 id="flags1-step 10d"),
    (["--sp", "2"], "not divisible by tp=1 × ep=1 × sp=2"),
    (["--ep", "2"], "--ep needs --moe-experts"),
    (["--hfta", "2"], "step 10e")])
def test_cli_refuses_what_is_not_ported(flags, step):
    """--hfta names the ROADMAP.md step that ports it; --tp, --pp, --sp
    and --ep (steps 10b, 10c and 10d, done) are refused in one process
    by the reference's checks: the mesh they ask for needs more ranks,
    and --ep needs experts (tests/test_torch_ep.py and test_torch_pp.py
    run them as gangs)."""
    with pytest.raises(ValueError, match=step):
        bench.main(["--size", "test", "--device", "cpu"] + flags)


def test_cli_runs_vit(capsys):
    """`--workload vit` (refused before ROADMAP.md step 7) runs
    run_vit_benchmark and prints the reference's headline metric."""
    assert bench.main(["--workload", "vit", "--size", "test",
                       "--image-size", "32", "--batch-per-device", "2",
                       "--num-steps", "2", "--warmup-steps", "1",
                       "--dtype", "float32", "--device", "cpu"]) == 0
    assert '"metric": "vit_images_per_sec"' in capsys.readouterr().out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_one_process_under_the_env_contract_writes_the_marker(
        tmp_path, monkeypatch, capsys):
    """A one-worker job under the controller's env contract bootstraps
    like a gang: initialize writes the readiness marker the gate waits on
    (the launcher is created only after it), and rank 0 serves the status
    channel a launcher polls for the exit code. A solo run without that
    env writes nothing and needs no coordinator."""
    import threading

    from mpi_operator_tpu_torch.bootstrap.bootstrap import (ProcessInfo,
                                                            launcher_wait)
    marker = tmp_path / "ready"
    coordinator, status = f"127.0.0.1:{_free_port()}", _free_port()
    seen = []
    launcher = threading.Thread(target=lambda: seen.append(launcher_wait(
        ProcessInfo(coordinator, num_processes=1, process_id=0,
                    is_launcher=True), port=status, poll_interval=0.1,
        startup_timeout=120.0)), daemon=True)
    launcher.start()
    args = ["--workload", "vit", "--size", "test", "--image-size", "32",
            "--batch-per-device", "2", "--num-steps", "2",
            "--warmup-steps", "1", "--dtype", "float32", "--device", "cpu"]
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_LAUNCHER",
              "TPU_NUM_SLICES", "TPU_EXPECTED_CHIPS", "TPU_FAULT_INJECT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("TPU_JOB_TOKEN", raising=False)
    monkeypatch.setenv("TPU_COORDINATOR_ADDRESS", coordinator)
    monkeypatch.setenv("TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("TPU_STATUS_PORT", str(status))
    monkeypatch.setenv("TPU_READY_FILE", str(marker))
    assert bench.main(args) == 0
    assert marker.read_text() == "ok\n"
    launcher.join(timeout=30)
    assert seen == [0]
    assert '"metric": "vit_images_per_sec"' in capsys.readouterr().out
    marker.unlink()
    for k in ("TPU_COORDINATOR_ADDRESS", "TPU_NUM_PROCESSES",
              "TPU_STATUS_PORT", "TPU_READY_FILE"):
        monkeypatch.delenv(k)
    assert bench.main(args) == 0
    assert not marker.exists()


@pytest.mark.parametrize("workload,extra", [
    ("gpt2", []), ("llama", []), ("bert", []),
    ("gpt2", ["--moe-experts", "4", "--accum-steps", "2"])],
    ids=["gpt2", "llama", "bert", "moe"])
def test_cli_trains_a_two_rank_gang(workload, extra):
    """The CLI as two gloo workers and the launcher on the env contract
    (the LMTrainer is data-parallel): every process exits 0, rank 0
    alone prints the headline, its global tokens/s, and the gang's final
    loss is one process's at the global batch (2 x 2 rows) from the same
    seeds."""
    common = ["--workload", workload, "--size", "test", "--seq-len", "16",
              "--dtype", "float32", "--warmup-steps", "1", "--num-steps",
              "2", "--device", "cpu", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               TPU_NUM_PROCESSES="2", TPU_STATUS_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([str(ROOT)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_LAUNCHER",
              "TPU_NUM_SLICES", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
           "lm_benchmark", "--batch-per-device", "2", *common]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, **role},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for role in ({"TPU_WORKER_ID": "0"}, {"TPU_WORKER_ID": "1"},
                          {"TPU_LAUNCHER": "1"})]
    try:
        outs = [(p.wait(timeout=240), p.stdout.read()) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [rc for rc, _ in outs] == [0, 0, 0], outs[0][1][-3000:]
    metric = f'"metric": "{workload}_tokens_per_sec"'
    assert metric in outs[0][1] and metric not in outs[1][1]
    head = json.loads([line for line in outs[0][1].splitlines()
                       if metric in line][-1])
    assert head["value"] > 0 and head["unit"] == "tokens/sec"
    assert "total tokens/sec:" in outs[0][1]
    kw = dict(moe_experts=4, accum_steps=2) if extra else {}
    _, m = bench.run_lm_benchmark(
        workload=workload, size="test", batch_per_device=4, seq_len=16,
        dtype_name="float32", warmup_steps=1, num_steps=2, device="cpu",
        log=lambda s: None, **kw)
    assert head["final_loss"] == pytest.approx(m["final_loss"], abs=2e-6)

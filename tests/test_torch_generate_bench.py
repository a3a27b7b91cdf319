"""The port's decode benchmark (`run_generate_benchmark`) and its MBU
accounting (`utils/flops.py`) against the JAX package's, on the CPU.

The byte count is arithmetic on shapes and must equal the reference's
exactly; MBU needs the card's HBM bandwidth, which the CPU does not
have, so it is None here (the H100 figure is the data sheet's 3.35
TB/s); a time from this run is a CPU time and is only checked to be
positive.
"""
import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

jflops = importlib.import_module("mpi_operator_tpu.utils.flops")
jt = importlib.import_module("mpi_operator_tpu.models.transformer")
tflops = importlib.import_module("mpi_operator_tpu_torch.utils.flops")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.lm_benchmark")

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
    (["--tp", "2"], "step 10"), (["--pp", "2"], "step 10"),
    (["--sp", "2"], "step 10"), (["--ep", "2"], "step 10"),
    (["--hfta", "2"], "step 10"), (["--workload", "vit"], "step 7")])
def test_cli_refuses_what_is_not_ported(flags, step):
    with pytest.raises(ValueError, match=step):
        bench.main(["--size", "test", "--device", "cpu"] + flags)

"""The port's benchmark orchestrator (``repro_torch.bench.suite``) and its
rows against the JAX package's ``benchmarks/`` scripts, on the CPU.

* OPT-α rows (``bench/opt_alpha_bench.py``): the same names and equal
  derived fields as ``benchmarks/bench_opt_alpha.py::run`` (the host numpy is
  the reference's line for line).
* Relay-kernel rows (``bench/kernel_bench.py``): the same names as
  ``benchmarks/bench_relay_kernel.py::run`` (its ``pallas_interp`` /
  ``pallas_fused`` are the port's ``hopper`` / ``hopper_fused``) and equal
  ``bytes``; the inputs are the reference's draws, and the port's plain
  outputs are within one bf16 ulp (rtol 2⁻⁷, atol 1e-5) of
  ``repro.kernels.ref`` and the wrappers' within the same of the Pallas
  kernels in interpret mode.
* ``roofline.relay_table`` equal line for line to the reference's over the
  JAX reports at the repository root, and the reference's line plus the
  device over a port report.
* ``roofline.table`` and ``tables.tables`` over synthetic records in both
  schemas and a real dry-run record: the reference's lines where the record
  is in its schema, apart from the 80 GB card; ``n/a`` and a lower bound
  for the port's.
* The ``suite`` CLI: ``--list`` and ``--skip-figures --device cpu``.

The JAX package and its scripts are imported inside the tests only.
"""
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch.bench import kernel_bench, opt_alpha_bench, roofline, suite, tables
from repro_torch.kernels import ref
from repro_torch.kernels import relay_mix as k
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL_BF16 = 1e-5, 2.0**-7


def _reference(module: str):
    """A script of the reference's ``benchmarks/`` folder."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{module}")


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def _close(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= ATOL + RTOL_BF16 * np.abs(want)), err.max()


# ---------------------------------------------------------------- OPT-α rows


def test_opt_alpha_rows_equal_the_reference():
    want = _reference("bench_opt_alpha").run()
    got = opt_alpha_bench.run()
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert len(got) == 12 and all(r[1] > 0 for r in got)


# ---------------------------------------------------------- relay-kernel rows


def test_kernel_rows_have_the_reference_names_and_bytes(capsys):
    want = _reference("bench_relay_kernel").run()
    got = kernel_bench.run(device="cpu")
    rename = {"einsum_ref": "einsum_ref", "pallas_interp": "hopper", "pallas_fused": "hopper_fused"}
    assert [r[0] for r in got] == [
        name.rsplit("/", 1)[0] + "/" + rename[name.rsplit("/", 1)[1]] for name, _, _ in want]
    for (_, _, d_got), (_, _, d_want) in zip(got, want):
        assert _fields(d_got)["bytes"] == _fields(d_want)["bytes"]
        assert _fields(d_got)["device"] == "cpu" and _fields(d_got)["dtype"] == "bf16"
    # the bound: bytes (the weights' included) over 3.35 TB/s; at n = 16 the
    # f32 operations take less
    for name, _, derived in got:
        f = _fields(derived)
        if name.endswith("/hopper"):
            assert float(f["bound_us"]) == pytest.approx(
                1e6 * (int(f["bytes"]) + 4 * 16 * 16) / 3.35e12, abs=1e-3)
        assert "tpu_est_us" not in f
    printed = capsys.readouterr().out.splitlines()
    assert printed[-len(got):] == [f"{n},{us:.3f},{d}" for n, us, d in got]


def test_kernel_cli_f32_rows_count_f32_bytes(capsys):
    kernel_bench.main(["--dtype", "f32", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 1 + 3 * len(kernel_bench.SIZES)
    rows = {line.split(",")[0]: _fields(line.split(",", 2)[2]) for line in lines[1:]}
    for D in kernel_bench.SIZES:
        assert int(rows[f"relay_kernel/D{D}/hopper"]["bytes"]) == 2 * 16 * D * 4
        assert int(rows[f"relay_kernel/D{D}/hopper_fused"]["bytes"]) == 17 * D * 4
        assert rows[f"relay_kernel/D{D}/einsum_ref"]["dtype"] == "f32"


def test_kernel_rows_raise_without_a_device_or_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.run()


@pytest.mark.parametrize("D", kernel_bench.SIZES)
def test_kernel_inputs_are_the_reference_draws_and_outputs_agree(D):
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels import relay_mix as jk

    # the reference's draws, in its order
    n = 16
    rng = np.random.default_rng(0)
    A_j = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    tau_j = jnp.asarray(rng.random(n) < 0.5, jnp.float32)
    for size in kernel_bench.SIZES:
        d_j = jnp.asarray(rng.standard_normal((n, size)), jnp.bfloat16)
        if size == D:
            break
    c_j = (1.0 / n) * tau_j @ A_j

    A, c, deltas = kernel_bench.draw_inputs(kernel_bench.SIZES, torch.bfloat16, "cpu")
    d = dict(deltas)[D]
    assert np.array_equal(A.numpy(), np.asarray(A_j))
    assert np.array_equal(d.view(torch.int16).numpy(),
                          np.asarray(d_j).view(np.int16))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=0, atol=1e-7)

    # the plain version (the einsum_ref row) against the reference's oracle
    _close(ref.relay_mix_2d(A, d), jref.relay_mix_2d(A_j, d_j))
    _close(ref.fused_aggregate_2d(c, d), jref.fused_aggregate_2d(c_j, d_j))
    # the wrappers (weights rounded to Δ's dtype) against the Pallas kernels
    _close(k.relay_mix_2d(A, d), jk.relay_mix_2d(A_j, d_j, interpret=True))
    c_same = torch.from_numpy(np.array(c_j))
    _close(k.fused_aggregate_2d(c_same, d), jk.fused_aggregate_2d(c_j, d_j, interpret=True))


# ---------------------------------------------------------------- relay table


def test_relay_table_equals_the_reference_over_the_root_reports():
    want = _reference("roofline").relay_table(csv=False)
    got = roofline.relay_table(root=str(ROOT), csv=False)
    assert len(want) == 4 and got == want


def test_relay_table_reads_a_port_report(tmp_path, capsys):
    suite.run_bench_scenarios(["relay_sweep_smoke"], device="cpu", out_dir=str(tmp_path))
    rows = capsys.readouterr().out.splitlines()
    assert rows[-1].startswith("bench/relay_sweep_smoke/summary,0,")
    assert "bitwise_match=True;device=cpu;report=" in rows[-1]
    assert {r.split(",")[0] for r in rows[:-1]} == {
        f"bench/relay_sweep_smoke/{e}" for e in ("loop", "scan", "pipelined",
                                                 "scan_hopper_fused")}
    got = roofline.relay_table(root=str(tmp_path), csv=False)
    want = _reference("roofline").relay_table(root=str(tmp_path), csv=False)
    assert len(got) == 1 and got[0] == want[0] + ",device=cpu"
    assert got[0].startswith("relay/relay_sweep_smoke,D=10282,n=8,")


# ------------------------------------------------------ roofline and tables

GB = 1e9


def _ok_ref(arch, shape, peak_gb, **kw):
    """A record in the reference's schema: a compiled peak, a collective."""
    return {"arch": arch, "shape": shape, "status": "ok", "relay_mode": "faithful",
            "roofline_seconds": {"compute": 1.5e-3, "memory": 4.25e-3, "collective": 2e-4},
            "bottleneck": "memory", "useful_flops_ratio": 0.5123,
            "per_device": {"peak_bytes": peak_gb * GB}, **kw}


def _ok_port(arch, shape, arg_gb, out_gb):
    """A record in the port's schema: no collective, no compiled peak."""
    return {"arch": arch, "shape": shape, "status": "ok", "relay_mode": "faithful",
            "roofline_seconds": {"compute": 2e-5, "memory": 2e-3, "collective": None},
            "bottleneck": "memory", "useful_flops_ratio": None,
            "per_device": {"argument_bytes": arg_gb * GB, "output_bytes": out_gb * GB,
                           "temp_bytes": None}}


RECORDS = {
    "pod16x16": {
        "a1__train_4k": _ok_ref("a1", "train_4k", 8.0),
        "a1__prefill_32k": _ok_ref("a1", "prefill_32k", 40.0),  # over 16 GB, under 80
        "a1__decode_32k": {"arch": "a1", "shape": "decode_32k", "status": "skipped",
                           "skip_reason": "too long for this arch"},
        "a1__long_500k": {"arch": "a1", "shape": "long_500k", "status": "error",
                          "error": "ValueError: dim 0 of size 3 does not divide over 2 ranks"},
        "a1__train_4k__fused": _ok_ref("a1", "train_4k", 6.0, relay_mode="fused"),
        "b2__decode_32k": _ok_port("b2", "decode_32k", 1.5, 0.75),
        "b2__train_4k": _ok_port("b2", "train_4k", 70.0, 20.0),  # args + outputs over 80 GB
    },
    "pod2x16x16": {
        "b2__decode_32k": _ok_port("b2", "decode_32k", 0.8, 0.4),
    },
}


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    for mesh, recs in RECORDS.items():
        (tmp_path / mesh).mkdir()
        for stem, rec in recs.items():
            (tmp_path / mesh / f"{stem}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path))
    return tmp_path


def test_roofline_table_reference_and_port_schemas(artifacts, monkeypatch):
    ref_roofline = _reference("roofline")
    got = roofline.table("pod16x16", csv=False)
    names = [line.split(",")[0] for line in got]
    assert names == [f"roofline/pod16x16/{stem.replace('__', '/')}" for stem in
                     sorted(RECORDS["pod16x16"])]
    rows = dict(zip(names, got))
    # the reference reads its own schema only (a port record has no
    # peak_bytes): its records alone
    ref_only = artifacts / "ref_only"
    (ref_only / "pod16x16").mkdir(parents=True)
    for stem in RECORDS["pod16x16"]:
        if stem.startswith("a1"):
            shutil.copy(artifacts / "pod16x16" / f"{stem}.json", ref_only / "pod16x16")
    monkeypatch.setattr(ref_roofline, "ARTIFACT_DIR", str(ref_only))
    want = {line.split(",")[0]: line for line in ref_roofline.table("pod16x16", csv=False)}
    assert len(want) == 5
    for name, line in want.items():
        if name.endswith("/prefill_32k"):  # 40 GB: over the v5e's 16, under the card's 80
            assert line.endswith(";OVER_HBM_x2.5")
            assert rows[name] == line.removesuffix("OVER_HBM_x2.5") + "fits"
        else:
            assert rows[name] == line
    assert rows["roofline/pod16x16/b2/decode_32k"] == (
        "roofline/pod16x16/b2/decode_32k,2000,compute=2.000e-05;memory=2.000e-03;"
        "collective=n/a;bottleneck=memory;useful_ratio=None;peak_gb>=2.25;args_out_fit")
    assert rows["roofline/pod16x16/b2/train_4k"].endswith(
        ";collective=n/a;bottleneck=memory;useful_ratio=None;peak_gb>=90.00;OVER_HBM_x1.1")
    assert not any("16 GB" in line for line in got)


def test_roofline_missing_mesh_gives_no_rows(artifacts, capsys):
    assert roofline.table("pod4x16x16") == [] and roofline.load("pod4x16x16") == []
    rows = roofline.run()
    assert capsys.readouterr().out.splitlines() == rows
    assert [r.split(",")[0].split("/")[1] for r in rows] == ["pod16x16"] * 7 + ["pod2x16x16"]


def test_tables_sections(artifacts, monkeypatch, capsys):
    ref_tables = _reference("make_tables")
    md = tables.tables()
    # the status matrix: every arch of both meshes, counted from the records
    # (the fused record apart, as the reference keys by arch and shape)
    assert "| a1 | ✓ / — | ✓ / — | skip / — | ✗ / — |" in md
    assert "| b2 | ✓ / — | — / — | ✓ / ✓ | — / — |" in md
    assert "\n7 combinations: **5 ok, 1 documented skips, 1 errors**." in md
    # the roofline rows: the reference's for its schema, but 80 GB
    (artifacts / "ref_only" / "pod16x16").mkdir(parents=True)
    for stem in ("a1__train_4k", "a1__prefill_32k", "a1__decode_32k"):
        shutil.copy(artifacts / "pod16x16" / f"{stem}.json", artifacts / "ref_only" / "pod16x16")
    monkeypatch.setattr(ref_tables, "ART", str(artifacts / "ref_only"))
    ref_tables.roofline_table("pod16x16", "t")
    want = [line for line in capsys.readouterr().out.splitlines() if line.startswith("| a1 ")]
    got = [line for line in tables.roofline_table("pod16x16", "t") if line.startswith("| a1 ")]
    assert len(want) == 3 and got[0] == want[0]
    assert want[1].endswith("| 40.00 | no (2.5×) |") and got[1] == want[1].replace(
        "no (2.5×)", "yes")
    assert got[2] == want[2]
    assert got[3] == ("| a1 | long_500k | — | — | — | — | — | — | "
                      "error: ValueError: dim 0 of size 3 does not divide over 2 ranks |")
    header = tables.roofline_table("pod16x16", "t")[1]
    assert header.endswith("| peak GB/dev | fits 80 GB |")
    port = {line.split(" | ")[1]: line for line in tables.roofline_table("pod16x16", "t")
            if line.startswith("| b2 ")}
    assert port["decode_32k"] == ("| b2 | decode_32k | 2.00e-05 | 2.00e-03 | n/a | memory | — | "
                                  "≥2.25 | args + outputs fit |")
    assert port["train_4k"].endswith("| ≥90.00 | no (1.1×) |")
    assert not any("16 GB" in line for line in md)
    # no baseline directory: the sections' headers and no rows
    base = tables.tables("baseline")
    assert [line for line in base if line.startswith("| ") and "---" not in line
            and not line.startswith("| arch")] == []
    multi = tables.tables("multipod")
    assert multi[-1].startswith("| b2 | decode_32k |") and "≥1.20" in multi[-1]


def test_tables_cli_and_missing_meshes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path / "none"))
    tables.main(["status"])
    out = capsys.readouterr().out
    assert "0 combinations: **0 ok, 0 documented skips, 0 errors**." in out
    assert tables.tables("roofline")[-1] == "|---|---|---|---|---|---|---|---|---|"


def test_roofline_over_a_real_dry_run_record(tmp_path, monkeypatch):
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    rec = dryrun.run_one("glm4-9b", "decode_32k", multi_pod=True, mesh=mesh, reduced=True,
                         out_dir=str(tmp_path / "pod2x16x16"))
    assert rec["status"] == "ok", rec.get("traceback")
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path))
    (line,) = roofline.table("pod2x16x16", csv=False)
    per = rec["per_device"]
    nbytes = per["argument_bytes"] + per["output_bytes"]
    r = rec["roofline_seconds"]
    assert line == (
        f"roofline/pod2x16x16/glm4-9b/decode_32k,{1e6 * max(r['compute'], r['memory']):.0f},"
        f"compute={r['compute']:.3e};memory={r['memory']:.3e};collective=n/a;"
        f"bottleneck={rec['bottleneck']};useful_ratio={round(rec['useful_flops_ratio'], 3)};"
        f"peak_gb>={nbytes / 1e9:.2f};args_out_fit")
    (row,) = [x for x in tables.tables("multipod") if x.startswith("| glm4-9b ")]
    assert f"| n/a | {rec['bottleneck']} |" in row and f"| ≥{nbytes / 1e9:.2f} |" in row


# ----------------------------------------------------------------- suite CLI


def test_suite_list(capsys):
    from repro_torch.bench import scenarios

    suite.main(["--list"])
    out = capsys.readouterr().out
    assert out.startswith("figure benchmarks:\n")
    for name in suite.FIGURES:
        assert f"  {name:>12}  " in out
    for spec in scenarios.list_scenarios():
        assert spec.name in out
    assert "name,us_per_call,derived" not in out


def test_suite_skip_figures_on_the_cpu(artifacts, tmp_path, monkeypatch, capsys):
    bench_dir = tmp_path / "bench"
    bench_dir.mkdir()
    shutil.copy(ROOT / "BENCH_relay_sweep_1e4.json", bench_dir)
    monkeypatch.setattr(roofline, "BENCH_DIR", str(bench_dir))
    monkeypatch.setattr(opt_alpha_bench, "CLIENTS", (10,))
    suite.main(["--skip-figures", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    kinds = [line.split("/")[0] for line in lines[1:]]
    assert kinds == ["opt_alpha"] * 3 + ["relay_kernel"] * 6 + ["roofline"] * 8 + ["relay"]
    assert lines[-1].startswith("relay/relay_sweep_1e4,D=")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            suite.main(["--skip-figures"])

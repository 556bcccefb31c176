"""The profiling and calibration entry points of the port
(`repro_torch.launch.profile`, `repro_torch.launch.calibrate`) against the
reference's (`repro.launch.profile`, `repro.launch.calibrate`), on the CPU.

* The port's kernel records equal the reference's analytic records (its
  compiler costs patched out inside the test) in kernel, quant, eta key,
  flops, bytes and count, and price them against the modeled H100 as the
  reference prices them against its TPU.
* ``kernels=["dequant_matmul"]`` gives the two per-format eta keys.
* ``calibrate`` writes the reference's profile and report, ``==``, on the
  synthetic fixture and on a trace the port's profile wrote.
* Without a card the profile refuses to run unless asked for the CPU; with
  ``--profile-dir`` it writes a chrome trace.
"""
import json
import sys

import pytest

from _torch_parity import jax, torch  # noqa: F401

import repro.launch.calibrate as jcal  # noqa: E402
import repro.launch.profile as jprofile  # noqa: E402
from repro.core.devices import CLOUD_GPU as J_CLOUD_GPU  # noqa: E402
from repro.qeil2.telemetry.fit import _eta_key as j_eta_key  # noqa: E402
from repro_torch.core.devices import CLOUD_GPU  # noqa: E402
from repro_torch.launch import calibrate as tcal  # noqa: E402
from repro_torch.launch import profile as tprofile  # noqa: E402
from repro_torch.obs import gpu_roofline_us  # noqa: E402
from repro_torch.qeil2.telemetry.fit import _eta_key as t_eta_key  # noqa: E402

KEYS = ["dequant_matmul:int4", "dequant_matmul:int8", "decode_attention",
        "flash_attention", "ssd_scan"]


@pytest.fixture(scope="module")
def reference():
    """The reference's profile at 1 rep with its compiled costs patched
    out, so that both sides stamp the analytic counts."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jprofile, "_compiled_costs", lambda fn, *args: None)
    try:
        return jprofile.run(verbose=False, reps=1)
    finally:
        mp.undo()


def _counts(records, eta_key):
    return [(r["kernel"], r["quant"], eta_key(r), r["flops"], r["bytes"])
            for r in records]


def test_profile_records_equal_the_reference_analytic_records(reference):
    port = tprofile.run(verbose=False, reps=1, device="cpu")
    assert _counts(port["records"], t_eta_key) == \
        _counts(reference["records"], j_eta_key)
    assert port["n_records"] == reference["n_records"] == 5
    assert sorted(t_eta_key(r) for r in port["records"]) == sorted(KEYS)
    assert {r["cost_source"] for r in reference["records"]} == {"analytic"}
    for r, s in zip(port["records"], port["kernels"]):
        assert (r["kind"], r["backend"], r["cost_source"], r["device"]) == \
            ("kernel", "cpu", "analytic", CLOUD_GPU.name)
        assert r["measured_us"] > 0
        # the reference's roofline formula over the reference's H100 model
        want = max(r["flops"] / (J_CLOUD_GPU.peak_flops * J_CLOUD_GPU.util),
                   r["bytes"] / (J_CLOUD_GPU.mem_bw * J_CLOUD_GPU.util))
        assert r["roofline_us"] == gpu_roofline_us(r["flops"], r["bytes"]) \
            == pytest.approx(want * 1e6, rel=1e-12)
        assert (s["kernel"], s["quant"], s["roofline_us"]) == \
            (r["kernel"], r["quant"], r["roofline_us"])
    assert set(port["records"][0]) == set(reference["records"][0])


def test_the_dequant_subset_gives_the_two_per_format_keys():
    res = tprofile.run(verbose=False, reps=2, kernels=["dequant_matmul"],
                       device="cpu")
    assert res["n_records"] == 4                     # int8 + int4, 2 reps
    assert sorted({t_eta_key(r) for r in res["records"]}) == \
        ["dequant_matmul:int4", "dequant_matmul:int8"]
    assert [r["rep"] for r in res["records"]] == [0, 1, 0, 1]


def _calibrate(tmp_path, monkeypatch, capsys, args):
    """Both packages' ``calibrate`` on ``args``: (profile, report, stdout)
    of each, the output paths written out of the text."""
    out = {}
    for side, main in (("ref", None), ("port", tcal.main)):
        d = tmp_path / side
        d.mkdir()
        argv = args + ["--out", str(d / "profile.json"),
                       "--report", str(d / "report.json")]
        if main is None:
            monkeypatch.setattr(sys, "argv", ["calibrate"] + argv)
            jcal.main()
        else:
            main(argv)
        text = capsys.readouterr().out.replace(str(d), "DIR")
        out[side] = (json.loads((d / "profile.json").read_text()),
                     json.loads((d / "report.json").read_text()), text)
    return out["ref"], out["port"]


def test_calibrate_on_the_synthetic_fixture_equals_the_reference(
        tmp_path, monkeypatch, capsys):
    ref, port = _calibrate(tmp_path, monkeypatch, capsys,
                           ["--synthetic", "--seed", "0", "--bootstrap",
                            "20"])
    assert port == ref
    assert ref[0]["kernel_eta"]


def test_calibrate_on_a_port_profile_trace_equals_the_reference(
        tmp_path, monkeypatch, capsys):
    trace = tmp_path / "kernels.jsonl"
    tprofile.main(["--device", "cpu", "--reps", "2", "--out", str(trace)])
    assert "appended 10 kernel records" in capsys.readouterr().out
    ref, port = _calibrate(tmp_path, monkeypatch, capsys,
                           ["--trace", str(trace), "--seed", "3",
                            "--bootstrap", "20"])
    assert port == ref
    assert sorted(dict(port[0]["kernel_eta"])) == sorted(KEYS)


def test_profile_refuses_without_a_card_unless_asked_for_the_cpu(tmp_path):
    tprofile.main(["--device", "cpu", "--reps", "1", "--kernels",
                   "dequant_matmul", "--profile-dir", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name", "").endswith("profile/dequant_matmul")
               for e in trace["traceEvents"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprofile.main(["--reps", "1"])

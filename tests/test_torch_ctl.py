"""The port's control-plane CLI (``repro_torch.launch.ctl``), as ``tests/test_launchers.py``
drives the reference's: submit with ``--wait``, status and artifacts print the
reference's lines, and a failed job exits non-zero."""
import pytest

from repro_torch.control import ControlPlane
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.core.dataset import build_model_dataset, synthetic_problems
from repro_torch.core.tuner import tune
from repro_torch.launch.ctl import main

CARD = "gpu_nvidia_h100_80gb_hbm3"


def test_ctl_cli_submit_status_artifacts(capsys):
    ds = build_model_dataset(synthetic_problems(40), device_name=CARD)
    bundle = DeploymentBundle({CARD: tune(ds, n_kernels=4, families=[]).deployment})
    with ControlPlane(port=0, tuner=lambda spec: bundle) as plane:
        main(["submit", "--url", plane.url, "--name", "fleet",
              "--devices", CARD, "--measure-budget", "auto", "--wait"])
        out = capsys.readouterr().out
        assert "job-0001 queued" in out and "job-0001 succeeded" in out
        ver = plane.registry.latest("fleet").version
        assert f"artifact fleet@{ver}" in out
        assert f"registry://127.0.0.1:{plane.port}/fleet/{ver}" in out
        assert plane.job("job-0001").spec["measure_budget"] == "auto"

        main(["status", "--url", plane.url])
        out = capsys.readouterr().out
        assert '"status": "ok"' in out
        assert "job-0001 [tune] succeeded -> fleet@" in out

        main(["artifacts", "--url", plane.url])
        assert f"fleet@{ver} seq=0" in capsys.readouterr().out


def test_ctl_cli_submit_failed_job_exits_nonzero(capsys):
    def tuner(spec):
        raise ValueError("no benchmarks on this host")

    with ControlPlane(port=0, tuner=tuner) as plane:
        with pytest.raises(SystemExit):
            main(["submit", "--url", plane.url, "--wait", "--timeout", "30"])
        out = capsys.readouterr().out
        assert "failed: ValueError: no benchmarks on this host" in out


def test_ctl_cli_transfer_job_fails_with_the_tune_clis_message(capsys):
    from repro_torch.core.tuner import TRANSFER_REFUSED

    with ControlPlane(port=0) as plane:
        with pytest.raises(SystemExit):
            main(["submit", "--url", plane.url, "--devices", "host_cpu", "--transfer", "--wait", "--timeout", "30"])
        assert f"failed: ValueError: {TRANSFER_REFUSED}" in capsys.readouterr().out
        main(["status", "--url", plane.url, "--job", "job-0001"])
        assert '"state": "failed"' in capsys.readouterr().out

"""The training launcher over a mesh on the CPU (``launch/train.py``):

- ``--mesh 1x2`` (two spawned gloo ranks, the vocabulary, heads and
  ``d_ff`` of the reduced qwen2-1.5b split in two) prints the losses of
  the single-device launcher within 1e-5, and so does its ``--resume``
  from a checkpoint the mesh saved (full leaves: the same files one
  device writes);
- the same for the ssm and hybrid families (``--steps 3``);
- ``--distributed --mesh 1x2`` under ``torchrun`` (one process a rank,
  ``env://``) prints them too;
- the argparse errors of ``--mesh`` and ``--distributed``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
RUN = ["--device", "cpu", "--arch", "qwen2-1.5b", "--reduced", "--batch",
       "2", "--seq", "64"]


def _losses(out: str) -> list:
    return [float(ln.split()[-1]) for ln in out.splitlines()
            if ln.startswith("step")]


def _main(capsys, *argv) -> str:
    launch_train.main([*RUN, *argv])
    return capsys.readouterr().out


def test_mesh_prints_single_device_losses_and_resumes(capsys, tmp_path):
    one = _main(capsys, "--steps", "20", "--ckpt-dir", str(tmp_path / "a"))
    mesh = _main(capsys, "--steps", "20", "--ckpt-dir", str(tmp_path / "b"),
                 "--mesh", "1x2")
    assert len(_losses(mesh)) == 3          # steps 0, 10 and 19
    assert _losses(mesh) == pytest.approx(_losses(one), rel=1e-5)
    one = _main(capsys, "--steps", "3", "--ckpt-dir", str(tmp_path / "a"),
                "--resume")
    mesh = _main(capsys, "--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                 "--resume", "--mesh", "1x2")
    assert "resumed from step 20" in one and "resumed from step 20" in mesh
    assert _losses(mesh) == pytest.approx(_losses(one), rel=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_mesh_trains_other_families(capsys, arch):
    argv = ["--arch", arch, "--steps", "3"]
    one = _losses(_main(capsys, *argv))
    mesh = _losses(_main(capsys, *argv, "--mesh", "1x2"))
    assert len(mesh) == 2 and mesh == pytest.approx(one, rel=1e-5)  # 0, 2


def test_distributed_under_torchrun(capsys):
    one = _losses(_main(capsys, "--steps", "3"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", *RUN,
         "--steps", "3", "--distributed", "--mesh", "1x2"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-4000:]
    assert _losses(r.stdout) == pytest.approx(one, rel=1e-5)


@pytest.mark.parametrize("argv, env, msg", [
    (["--distributed"], {}, "--distributed needs --mesh"),
    (["--mesh", "2"], {}, "--mesh wants DxM"),
    (["--mesh", "0x2"], {}, "--mesh dims must be >= 1"),
    (["--distributed", "--mesh", "1x2"], {}, "needs torchrun's RANK"),
    (["--distributed", "--mesh", "1x2"], {"RANK": "0", "WORLD_SIZE": "3"},
     "--mesh 1x2 has 2 ranks, WORLD_SIZE is 3"),
], ids=["no-mesh", "not-DxM", "zero", "no-env", "world"])
def test_mesh_argparse_errors(argv, env, msg, capsys, monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        launch_train.main([*RUN, *argv])
    assert e.value.code == 2 and msg in capsys.readouterr().err


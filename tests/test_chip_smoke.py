"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases passes at a small size (the card runs them at full width)."""
import jax
import pytest

import chip_smoke

SMALL_TUM = dict(fx=131.25, fy=131.25, cx=79.5, cy=59.5, width=160,
                 height=120)
SMALL_EUROC = dict(fx=140.0, fy=140.0, cx=95.5, cy=63.5, width=192,
                   height=128, k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5)


@pytest.fixture
def rep():
    return chip_smoke.Report("cpu")


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_pyramid_phase(rep, cpu):
    chip_smoke.phase_pyramid(rep, cpu, H=120, W=160, batch=4, levels=4)
    assert not rep.failed


def test_sampling_phase(rep, cpu):
    chip_smoke.phase_sampling(rep, cpu, H=120, W=160, n=512)
    assert not rep.failed


def test_linalg_phase(rep, cpu):
    chip_smoke.phase_linalg(rep, cpu)
    assert not rep.failed


def test_rectify_phase(rep, cpu):
    chip_smoke.phase_rectify(rep, cpu)
    assert not rep.failed


def test_report_counts_failures(rep, capsys):
    rep.check("x", 2.0, 1.0, "over")
    rep.check("y", float("nan"), 1.0, "nan")
    rep.run("z", lambda r: 1 / 0)
    assert rep.failed == ["x", "y", "z"]
    assert "[cpu] x: FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_cli_phase(case, rep, tmp_path):
    chip_smoke.phase_cli(
        rep, str(tmp_path), cam_kw=SMALL_TUM, n=18, n_points=512, levels=4,
        euroc_raw=SMALL_EUROC, euroc_out=(192, 128), cpu_frames=8,
        only=case,
    )
    assert not rep.failed


def test_four_card_dist_ba_on_virtual_devices(rep):
    chip_smoke.phase_dist_ba(rep, jax.devices()[:4],
                             sizes=((24, 300), (24, 3000)))
    assert not rep.failed


def test_four_card_sharded_tracking_on_virtual_devices(rep):
    chip_smoke.phase_sharded_tracking(
        rep, jax.devices()[:4], n=13, cam_kw=SMALL_TUM, n_points=256,
        levels=4, track_levels=(2, 1, 0),
    )
    assert not rep.failed

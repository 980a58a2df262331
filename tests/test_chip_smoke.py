"""chip_smoke.py's phases on CPU at small sizes: each drives the serving
path and checks it against the NumPy reference exactly as on the card
(the hailfinder-class phase is left to the card: its cliques hold 12.4M
states).  The four-card phases run on four of the virtual CPU devices."""

import jax
import pytest

import chip_smoke as cs

SMALL = dict(uai_b=64, map_b=32, hail_b=8, hail_chunk=4, clique_nv=12,
             clique_obs=8, clique_b=64, rows=4, hail_rows=1, chain_n=64,
             chain_b=16)


def test_one_card_phases(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    dev = jax.devices()[0]
    cs.phase_uai(SMALL, dev, "cpu")
    assert (tmp_path / "grid7x7_card3.MAR").exists()
    clique = cs.phase_clique(SMALL, dev, "cpu")
    cs.phase_factored(SMALL, dev, "cpu", clique)


@pytest.mark.parametrize("phase", ["four_dp", "four_tp", "four_sp"])
def test_four_card_phases(phase):
    assert len(jax.devices()) >= 4
    getattr(cs, f"phase_{phase}")(SMALL, "cpu")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err and '"ok"' not in out.out

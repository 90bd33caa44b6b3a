"""PyTorch port, the serving driver (`repro_torch.launch.serve`): the two
smoke tests of `tests/test_serve_driver.py` on the CPU (``--device cpu``).

Decode-only mode (the batched prefill + decode loop) and the coupled mode
(training under live serve traffic on the device event stream, then decode
from the trained weights) both run on a smoke config with finite logits
and exact request conservation.  Without ``--device`` the driver asks for
the card and raises where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch.serve import run_serve  # noqa: E402

_TINY = [
    "--arch", "mamba2-130m", "--preset", "small",
    "--batch", "2", "--prompt-len", "4", "--steps", "4", "--device", "cpu",
]


def test_decode_only_smoke():
    r = run_serve(_TINY + ["--train-steps", "0"])
    assert r["logits_finite"]
    assert r["generated"].shape == (2, 4)  # (batch, decode steps)
    assert r["tok_per_s"] > 0
    assert "serve_arrivals" not in r  # no training plane requested


def test_train_under_traffic_then_decode_smoke():
    r = run_serve(_TINY + [
        "--train-steps", "40", "--clients", "4", "--concurrency", "2",
        "--arrival-rate", "2.0", "--serve-rate", "4.0",
        "--deadline", "1.0", "--max-retries", "1",
    ])
    # decode plane: the trained weights produce finite logits
    assert r["logits_finite"]
    assert r["generated"].shape == (2, 4)
    # training plane: the merged run accounted for every request exactly
    arr = int(r["serve_arrivals"])
    acct = (int(r["serve_served"]) + int(r["serve_shed"])
            + int(r["serve_timed_out"]) + int(r["serve_pending"]))
    assert arr == acct
    assert int(r["serve_kg_step"]) > 0
    assert np.isfinite(float(r["serve_checksum"]))
    assert r["train_wall_s"] > 0


def test_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve(["--arch", "mamba2-130m", "--steps", "1", "--prompt-len", "1"])

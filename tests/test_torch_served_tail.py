"""The served-tail probe (``probes/served_tail.py``) on the CPU at a tiny
size: one record a series and repeat, every reply held to the direct
call inside the probe, and each request's layers nested as the calls
are (the client's clock around the handler's, the handler's around the
pool's, the pool's around the device call's)."""

import numpy as np

from a_nice_rag_tpu_torch.probes import served_tail
from a_nice_rag_tpu_torch.probes.served_tail import LAYERS


def test_served_tail_records_nested_layers(capsys):
    out = served_tail.run(n_docs=4096, requests=8, repeats=2, device="cpu")
    assert [(r["series"], r["repeat"]) for r in out] == [
        ("json_b1", 0), ("b64_b8", 0), ("json_b1", 1), ("b64_b8", 1)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4
    for rec in out:
        assert rec["requests"] == 8 and rec["card"] == "cpu"
        assert len(rec["gc_collections"]) == 3
        for name in LAYERS:
            s = rec[f"{name}_ms"]
            assert 0 < s["p50"] <= s["p90"] <= s["p99"] <= s["max"]
        slow = rec["slowest"]
        assert len(slow) == 6
        assert [r["client"] for r in slow] == sorted(
            (r["client"] for r in slow), reverse=True)
        for r in slow:
            chain = [r[name] for name in LAYERS]
            assert np.all(np.diff(chain) <= 0), r


def test_served_tail_cli(capsys):
    assert served_tail.main(["--n-docs", "2048", "--requests", "4",
                             "--repeats", "1", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_layers_settle_waits_for_every_record():
    """The handler's record lands after its reply: ``settle`` waits for
    a late one and raises when a layer holds another count."""
    import threading

    import pytest

    layers = served_tail._Layers()
    for name in LAYERS[:-1]:
        layers.add(name, 1.0)
    late = threading.Timer(0.05, layers.add, (LAYERS[-1], 1.0))
    late.start()
    layers.settle(1)
    late.join(timeout=10)
    layers.add(LAYERS[0], 1.0)
    with pytest.raises(AssertionError, match="one record a request"):
        layers.settle(1, timeout_s=0.01)
    layers.clear()
    with pytest.raises(AssertionError, match="one record a request"):
        layers.settle(1, timeout_s=0.01)

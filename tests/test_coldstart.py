"""Cold-start attribution monitor (coldstart.py): the bench artifact's
setup_breakdown depends on these event captures being correct."""

import logging

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")


def test_monitor_captures_compile_events():
    from pseudoaligner_tpu.coldstart import JitEventMonitor

    mon = JitEventMonitor().start()
    try:
        fn = jax.jit(lambda x: x * 2 + 1)
        assert int(fn(np.int32(20))) == 41
    finally:
        mon.stop()
    s = mon.summary()
    # a fresh jitted program -> at least one trace + one compile
    # (or persistent-cache events when a cache is configured)
    assert len(mon.events) >= 2
    assert s["trace_s"] > 0
    assert s["xla_compile_s"] > 0 or s["cache_hits"] > 0


def test_monitor_restores_logger_state_and_passes_warnings(capsys):
    from pseudoaligner_tpu.coldstart import JitEventMonitor, _WATCHED

    lg = logging.getLogger(_WATCHED[0])
    before = (lg.level, lg.propagate, list(lg.handlers))
    mon = JitEventMonitor().start()
    try:
        assert lg.propagate is False
        # a WARNING through the muted logger must still reach root
        root = logging.getLogger()
        records = []

        class Cap(logging.Handler):
            def emit(self, rec):
                records.append(rec.getMessage())

        h = Cap()
        root.addHandler(h)
        try:
            lg.warning("synthetic diagnostic %d", 42)
        finally:
            root.removeHandler(h)
        assert any("synthetic diagnostic 42" in m for m in records)
    finally:
        mon.stop()
    assert (lg.level, lg.propagate, list(lg.handlers)) == before

"""The port's loader and prefetch watchdogs, and the flags the CLI reads.

Mirrors of ``tests/test_data.py``'s watchdog tests (:187-340) for the
port's ``Loader`` and ``device_prefetch`` (``data/pipeline.py``): a
stalled decode or fetch raises a named ``PipelineStallError`` within its
timeout, a wedged thread cannot keep the interpreter from exiting, and a
timeout <= 0 turns a watchdog off. The hangs are test-releasable events
and the timeouts are 0.5 s or less, as in JAX. The last tests hold the
flag surface to the invariant ROADMAP.md states: every flag the port
parses is read, stopped by ``check_ported`` or listed as inert with a
printed note.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dasemanticsegmentationaml_tpu_torch import cli
from dasemanticsegmentationaml_tpu_torch.data import pipeline as pl
from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
    Loader, PipelineStallError, device_prefetch)
from dasemanticsegmentationaml_tpu_torch.utils.config import (build_parser,
                                                              parse_args)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dasemanticsegmentationaml_tpu_torch")


def _sample(idx):
    return (np.full((4, 4, 3), idx, np.uint8), np.full((4, 4), idx, np.uint8))


class _Hanging:
    """Eight samples; ``idx`` in ``hang`` waits on ``release`` (up to 30 s)
    or sleeps ``sleep`` seconds."""

    def __init__(self, hang=(), release=None, sleep=0.0):
        self.hang, self.release, self.sleep = set(hang), release, sleep

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        if idx in self.hang:
            if self.release is not None:
                self.release.wait(timeout=30.0)
            else:
                time.sleep(self.sleep)
        return _sample(idx)


def test_port_loader_watchdog_names_the_stalled_decode():
    """tests/test_data.py:187: batch 1, dataset index 5, the dataset's
    type and the worker count in the message, raised in time."""
    release = threading.Event()
    loader = Loader(_Hanging({5}, release), batch_size=4, num_workers=2,
                    worker_timeout=0.5)
    t0 = time.monotonic()
    try:
        with pytest.raises(PipelineStallError) as exc:
            list(loader)
        msg = str(exc.value)
        assert "decode worker stalled" in msg
        assert "batch 1" in msg and "index 5" in msg
        assert "_Hanging" in msg and "num_workers=2" in msg
        assert time.monotonic() - t0 < 10.0
    finally:
        release.set()


def test_port_loader_stall_leaves_the_interpreter_free_to_exit():
    """tests/test_data.py:224: past a worker wedged for ever, the process
    still ends (the decode pool's threads are daemons)."""
    code = r"""
import sys, threading
from dasemanticsegmentationaml_tpu_torch.data.pipeline import (
    Loader, PipelineStallError)

class Forever:
    def __len__(self): return 4
    def __getitem__(self, idx):
        if idx == 1:
            threading.Event().wait()
        return idx, idx

try:
    list(Loader(Forever(), batch_size=2, num_workers=2, worker_timeout=0.3))
except PipelineStallError:
    print("STALL-RAISED")
    sys.exit(0)
"""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], timeout=60,
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "STALL-RAISED" in proc.stdout
    assert time.monotonic() - t0 < 45.0


def test_port_prefetch_watchdog_names_a_stalled_prepare():
    """tests/test_data.py:264 (there a stalled ``device_put``; here the
    host-to-device dispatch is ``prepare_batch``, inside the fetch): the
    first fetch stalls and is named; without the watchdog the batches
    arrive."""
    release = threading.Event()
    host = [_batch(i) for i in range(3)]

    def stalled(batch):
        release.wait(timeout=30.0)
        return pl.prepare_batch(*batch, device=torch.device("cpu"))

    t0 = time.monotonic()
    try:
        with pytest.raises(PipelineStallError) as exc:
            list(device_prefetch((stalled(b) for b in host),
                                 transfer_timeout=0.5))
        assert "input fetch stalled" in str(exc.value)
        assert "batch 0" in str(exc.value)
        assert time.monotonic() - t0 < 10.0
    finally:
        release.set()
    out = list(device_prefetch((stalled(b) for b in host),
                               transfer_timeout=None))
    assert len(out) == 3


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (2, 4, 8, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 19, (2, 4, 8), dtype=np.uint8)))


def test_port_prefetch_watchdog_covers_the_upstream_iterator():
    """tests/test_data.py:297: the trainers prefetch prepared batches, so
    the wait that can wedge is the upstream iterator itself; the second
    fetch stalls and is named."""
    release = threading.Event()

    def prepared():
        yield pl.prepare_batch(*_batch(0), device=torch.device("cpu"))
        release.wait(timeout=30.0)
        yield pl.prepare_batch(*_batch(1), device=torch.device("cpu"))

    t0 = time.monotonic()
    try:
        with pytest.raises(PipelineStallError) as exc:
            list(device_prefetch(prepared(), transfer_timeout=0.5))
        assert "input fetch stalled" in str(exc.value)
        assert "batch 1" in str(exc.value)
        assert time.monotonic() - t0 < 10.0
    finally:
        release.set()


@pytest.mark.parametrize("timeout", [0, -1.0, None])
def test_port_watchdogs_off_at_zero_or_below(timeout):
    """<= 0 or None turns each watchdog off (JAX pipeline.py:159-162,
    266-267): a decode and a fetch slower than any timeout finish, and the
    fetches run in the calling thread."""
    loader = Loader(_Hanging({2}, sleep=0.6), batch_size=4, num_workers=2,
                    worker_timeout=timeout)
    assert loader.worker_timeout is None
    batches = list(loader)
    assert [int(b[0][i, 0, 0, 0]) for b in batches for i in range(4)] == \
        list(range(8))
    threads = []

    def slow():
        for i in range(3):
            threads.append(threading.current_thread())
            time.sleep(0.6 if i == 1 else 0.0)
            yield i

    assert list(device_prefetch(slow(), transfer_timeout=timeout)) == [0, 1,
                                                                      2]
    assert set(threads) == {threading.current_thread()}


def test_port_watched_fetches_run_in_a_daemon_thread_in_order():
    """With the watchdog on, each fetch runs in the prefetch's daemon
    thread, two ahead of the consumer, in order."""
    threads, seen = [], []

    def batches():
        for i in range(5):
            threads.append(threading.current_thread())
            seen.append(i)
            yield i

    got = []
    for b in device_prefetch(batches(), transfer_timeout=5.0):
        got.append((b, len(seen)))
    assert got == [(0, 3), (1, 4), (2, 5), (3, 5), (4, 5)]
    assert {t.name for t in threads} == {"prefetch-0"}
    assert all(t.daemon for t in threads)


def _package_sources():
    for dirpath, _, names in os.walk(PKG):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    yield f.read()


def test_port_every_flag_is_read_stopped_or_inert():
    """Each flag of the port's parser is read by the package
    (``args.<dest>`` or ``getattr(args, "<dest>"``; ``check_ported``
    reads the ones it stops on), or is listed in ``cli.INERT_FLAGS``,
    never both. This is how an accepted-and-ignored flag (the watchdogs
    before this test existed) is caught."""
    text = "\n".join(_package_sources())
    dests = [a.dest for a in build_parser()._actions if a.dest != "help"]
    unread, both = [], []
    for dest in dests:
        read = re.search(rf"args\.{dest}\b|getattr\(args, \"{dest}\"",
                         text) is not None
        inert = dest in cli.INERT_FLAGS
        if not read and not inert:
            unread.append(dest)
        if read and inert:
            both.append(dest)
    assert not unread, f"flags neither read nor listed inert: {unread}"
    assert not both, f"flags listed inert but read: {both}"
    assert set(cli.INERT_FLAGS) <= set(dests)


@pytest.mark.parametrize("dest", sorted(cli.INERT_FLAGS))
def test_port_inert_flag_prints_its_note(dest):
    """A value other than the default prints the flag's note; the
    default prints nothing."""
    default = build_parser().get_default(dest)
    value = (str(not default) if isinstance(default, bool)
             else "2")
    assert cli.inert_flag_notes(parse_args([])) == []
    notes = cli.inert_flag_notes(parse_args([f"--{dest}", value]))
    assert notes == [cli.INERT_FLAGS[dest]]

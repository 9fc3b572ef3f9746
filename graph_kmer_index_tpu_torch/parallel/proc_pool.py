"""Subprocess worker pool: spawn-fresh workers without ``__main__`` replay
(the port's copy of graph_kmer_index_tpu/parallel/proc_pool.py).

Why not ``multiprocessing.get_context("spawn")``: a spawn child re-runs
the parent's ``__main__`` module (as ``__mp_main__``). When the parent is
a script that imported us and calls into the pool from top-level code,
that replay re-executes the script inside every worker (or dies outright
when ``__main__`` is stdin/interactive). The reference never hits this
because its pools fork (command_line_interface.py:574-623); we need fresh
processes *after* CUDA is initialised in the parent, where fork is the
hazard instead.

So: workers are ``Popen([sys.executable, -u, -m, <this module>])``:
their ``__main__`` is this module's protocol loop, importable and inert,
regardless of what the parent process's ``__main__`` is. Work functions
travel by module-path reference (pickle), the graph/init payload once per
worker, then length-prefixed pickle frames per task. Workers get an
environment without the card (``CUDA_VISIBLE_DEVICES`` empty): the chunk
functions are host-only numpy/native by construction (host_pool.py), and
the parent owns the device. They import the package's host layer only
(numpy; torch is imported by the device modules, which no chunk function
touches), which keeps their start-up short. The package's parent
directory is put on their ``PYTHONPATH``, so the pool also works from a
checkout that is not installed.
"""
from __future__ import annotations

import io
import logging
import os
import pickle
import selectors
import struct
import subprocess
import sys
import traceback

_LEN = struct.Struct("<Q")


def _frame(obj) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


def _write_frame(stream, obj) -> None:
    stream.write(_frame(obj))
    stream.flush()


def _read_exact(stream, n: int) -> bytes:
    chunks = []
    while n:
        b = stream.read(n)
        if not b:
            raise EOFError("worker pipe closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _read_frame(stream):
    (n,) = _LEN.unpack(_read_exact(stream, _LEN.size))
    return pickle.loads(_read_exact(stream, n))


_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker_env() -> dict:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # workers are host-only by contract
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_PARENT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


class SubprocessPool:
    """Minimal imap_unordered over ``python -m``-launched workers, which
    start (and import) side by side.

    Protocol (all frames ``<u64 length><pickle>`` on stdin/stdout):
      parent -> worker:  ("init", initializer, initargs) once,
                         ("task", key, fn, arg) repeatedly, ("stop",).
      worker -> parent:  ("ok", key, result) | ("err", key, traceback_str).

    Each worker holds at most one task; completions are yielded as they
    arrive and the freed worker is immediately refilled, matching the
    scheduling (and crash semantics: a dead worker raises, it never hangs)
    of ``Pool.imap_unordered`` as used by host_pool._find_pooled.
    """

    def __init__(self, n_workers: int, initializer=None, initargs=()):
        self._init = (initializer, initargs)
        # every worker is started before the first init payload is sent:
        # a payload larger than the pipe's buffer (a graph) blocks until
        # its worker has finished importing and reads it, and workers
        # started one after such a write would import one after another
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-u", "-m",
                 "graph_kmer_index_tpu_torch.parallel.proc_pool"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=_worker_env())
            for _ in range(max(1, int(n_workers)))]
        init = _frame(("init", initializer, initargs))  # pickled once
        try:
            for p in self._procs:
                p.stdin.write(init)
                p.stdin.flush()
        except BaseException:
            self.close()
            raise

    def imap_unordered(self, fn, keyed_args):
        """Yield ``(key, fn(arg))`` for ``(key, arg)`` pairs, completion
        order."""
        pending = list(keyed_args)[::-1]  # pop() from the front
        sel = selectors.DefaultSelector()
        busy = 0
        try:
            for p in self._procs:
                if not pending:
                    break
                key, arg = pending.pop()
                _write_frame(p.stdin, ("task", key, fn, arg))
                sel.register(p.stdout, selectors.EVENT_READ, p)
                busy += 1
            while busy:
                for sk, _ in sel.select():
                    p = sk.data
                    status, key, payload = _read_frame(p.stdout)
                    if status == "err":
                        raise RuntimeError(
                            f"pool worker failed on task {key!r}:\n"
                            f"{payload}")
                    if pending:
                        nkey, narg = pending.pop()
                        _write_frame(p.stdin, ("task", nkey, fn, narg))
                    else:
                        sel.unregister(p.stdout)
                        busy -= 1
                    yield key, payload
        finally:
            sel.close()
            self.close()

    def close(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                try:
                    _write_frame(p.stdin, ("stop",))
                    p.stdin.close()
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                logging.warning("pool worker pid %d did not exit; killing",
                                p.pid)
                p.kill()
                p.wait()
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _serve() -> None:
    """Worker protocol loop (this module run with ``-m``)."""
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    # anything the task functions print must not corrupt the frame
    # stream; route their stdout to stderr
    sys.stdout = io.TextIOWrapper(io.FileIO(sys.stderr.fileno(),
                                            "w", closefd=False))
    while True:
        try:
            msg = _read_frame(stdin)
        except EOFError:
            return
        if msg[0] == "stop":
            return
        if msg[0] == "init":
            _, initializer, initargs = msg
            if initializer is not None:
                initializer(*initargs)
            continue
        _, key, fn, arg = msg
        try:
            result = ("ok", key, fn(arg))
        except BaseException:
            result = ("err", key, traceback.format_exc())
        _write_frame(stdout, result)


if __name__ == "__main__":
    _serve()

"""Step timing, ETA and the ``DEBUGGING``-gated profiling decorator
(counterpart of ``fsnet_tpu.utils.timer``)."""
from __future__ import annotations

import functools
import os
import time

import torch


def _is_debugging() -> bool:
    return os.environ.get("DEBUGGING", "").lower() in ("1", "true")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile(name: str = "", start: int = 0, end: int = 100000):
    """Print the latency of calls ``start`` to ``end - 1`` of the wrapped
    function when ``DEBUGGING=1``: the CUDA device is synchronised before
    and after the call, so the time includes the work it queued there.
    Without ``DEBUGGING`` the function is returned unwrapped."""

    def decorator(func):
        if not _is_debugging():
            return func
        call_count = [0]

        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            idx = call_count[0]
            call_count[0] += 1
            if not (start <= idx < end):
                return func(*args, **kwargs)
            _sync()
            t0 = time.perf_counter()
            result = func(*args, **kwargs)
            _sync()
            print(f"[profile] {name or func.__name__} call {idx}: "
                  f"{(time.perf_counter() - t0) * 1000.0:.2f} ms")
            return result

        return wrapped

    return decorator


def formatting_time(seconds: float) -> str:
    """Format seconds as 'Dd HH:MM:SS'."""
    seconds = int(max(seconds, 0))
    days, rem = divmod(seconds, 86400)
    hours, rem = divmod(rem, 3600)
    minutes, secs = divmod(rem, 60)
    if days > 0:
        return f"{days}d {hours:02d}:{minutes:02d}:{secs:02d}"
    return f"{hours:02d}:{minutes:02d}:{secs:02d}"


class Timer:
    """Wall-clock ETA of the training loop."""

    def __init__(self):
        self.start_time = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start_time

    def compute_eta(self, done_steps: int, total_steps: int) -> str:
        if done_steps <= 0:
            return "--:--:--"
        rate = self.elapsed() / done_steps
        return formatting_time(rate * (total_steps - done_steps))

"""A time limit for a slow test case (the tests run without a timeout
plugin)."""

import contextlib
import signal


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail what runs inside once it has taken ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"over its time limit of {seconds} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)

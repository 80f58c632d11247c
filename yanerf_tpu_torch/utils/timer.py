"""Wall-clock timers, as ``yanerf_tpu/utils/timer.py`` has them.

``Timer`` measures since-start / since-last-check intervals and works as a
context manager; ``check_time`` keeps a global registry of named timers.
The runner's loops split each step's span with one ``Timer``
(``runners/apis.py``: ``data``, ``inference``).
"""

from __future__ import annotations

from time import perf_counter


class TimerError(Exception):
    def __init__(self, message):
        self.message = message
        super().__init__(message)


class Timer:
    """A flexible wall-clock timer."""

    def __init__(self, start: bool = True, print_tmpl: str = "{:.3f}"):
        self._is_running = False
        self.print_tmpl = print_tmpl
        self._t_start = 0.0
        self._t_last = 0.0
        if start:
            self.start()

    @property
    def is_running(self) -> bool:
        return self._is_running

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        print(self.print_tmpl.format(self.since_last_check()))
        self._is_running = False

    def start(self) -> None:
        if not self._is_running:
            self._t_start = perf_counter()
            self._is_running = True
        self._t_last = perf_counter()

    def since_start(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        self._t_last = perf_counter()
        return self._t_last - self._t_start

    def since_last_check(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        dur = perf_counter() - self._t_last
        self._t_last = perf_counter()
        return dur


_g_timers: dict = {}


def check_time(timer_id: str) -> float:
    """Running time since the last call of ``check_time`` with this id.

    Returns 0 on the first call for a given id.
    """
    if timer_id not in _g_timers:
        _g_timers[timer_id] = Timer()
        return 0.0
    return _g_timers[timer_id].since_last_check()

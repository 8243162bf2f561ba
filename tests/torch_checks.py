"""Shared runner for the PyTorch-port test files (``tests/test_torch_*.py``).

Each of those files collects exactly ONE test item that runs all of the
file's cases through :func:`run_checks`. The reason is the scheduler of
the suite's parallel run (pytest-xdist, ``--dist loadfile``): it orders
files by their number of collected tests, largest first, and hands them
to workers in that order. A new file with many tests lands mid-queue and
shifts every smaller file onto other workers, after other files; some
existing tests depend on what ran before them on their worker (a mesh or
flag left behind). A file with one test sorts after every existing file,
so adding it leaves the existing files' schedule as it was.
"""


def run_checks(checks):
    """Run every ``(fn, args)`` case, then fail once naming each case
    that failed (a skip still ends the run at once)."""
    failures = []
    for fn, args in checks:
        try:
            fn(*args)
        except Exception as e:
            failures.append(f"{fn.__name__}{tuple(args)}: "
                            f"{type(e).__name__}: {e}")
    if failures:
        raise AssertionError(f"{len(failures)} of {len(checks)} cases "
                             f"failed:\n" + "\n".join(failures))

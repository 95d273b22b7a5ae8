"""Shared pytest fixtures. NOTE: no XLA_FLAGS here — smoke tests must see 1 device;
only the dry-run (its own subprocess) requests 512 placeholder devices.

Also installs a pure-pytest fallback for ``hypothesis`` when the optional dependency
is absent: ``@given``-decorated tests then run a fixed number of deterministic
pseudo-random examples instead of erroring at collection. ``pip install hypothesis``
(see requirements-dev.txt) restores full property-based shrinking/coverage.
"""
import functools
import random
import sys
import types
import zlib

import jax
import pytest

try:  # real hypothesis wins whenever it's installed
    import hypothesis  # noqa: F401
except ModuleNotFoundError:

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rnd):
            return self._draw(rnd)

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def _floats(min_value=0.0, max_value=1.0, allow_nan=True, allow_infinity=None,
                width=64):
        return _Strategy(lambda rnd: rnd.uniform(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rnd: rnd.random() < 0.5)

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rnd: seq[rnd.randrange(len(seq))])

    def _lists(elements, min_size=0, max_size=10):
        return _Strategy(
            lambda rnd: [elements.draw(rnd)
                         for _ in range(rnd.randint(min_size, max_size))]
        )

    _DEFAULT_MAX_EXAMPLES = 15

    def _given(*arg_strategies, **kw_strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_shim_max_examples", _DEFAULT_MAX_EXAMPLES)
                rnd = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for _ in range(n):
                    drawn = [s.draw(rnd) for s in arg_strategies]
                    drawn_kw = {k: s.draw(rnd) for k, s in kw_strategies.items()}
                    fn(*args, *drawn, **kwargs, **drawn_kw)

            # functools.wraps sets __wrapped__, which would make pytest see the
            # original signature and treat drawn arguments as fixtures
            del wrapper.__wrapped__
            wrapper.is_hypothesis_test = True
            return wrapper

        return deco

    def _settings(deadline=None, max_examples=_DEFAULT_MAX_EXAMPLES, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.lists = _lists
    _st.sampled_from = _sampled_from

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where no CUDA device is visible")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)

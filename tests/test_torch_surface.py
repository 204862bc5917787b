"""The port's package surface against the JAX package's: every public name
of parakeet_tpu is exported by parakeet_tpu_torch or on the port's explicit
list of names not ported, and that list holds nothing else."""

import pytest

import parakeet_tpu as R
import parakeet_tpu_torch as T


def test_every_reference_name_is_exported_or_listed():
    missing = sorted(set(R.__all__) - set(T.__all__))
    assert missing == sorted(T.NOT_PORTED)
    assert not set(T.NOT_PORTED) & set(T.__all__)
    assert len(set(T.NOT_PORTED)) == len(T.NOT_PORTED) == 4


@pytest.mark.parametrize("name", sorted(set(R.__all__) - set(T.NOT_PORTED)))
def test_exported_name_resolves(name):
    assert name in T.__all__
    assert getattr(T, name) is not None
    # a class or function keeps the reference's name (no alias of another)
    ref = getattr(R, name)
    if hasattr(ref, "__name__"):
        assert getattr(T, name).__name__ == ref.__name__


def test_all_is_exact():
    assert len(T.__all__) == len(set(T.__all__))
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.__version__ == R.__version__

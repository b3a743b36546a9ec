"""Shared test helpers.

``hypothesis_or_stub`` lets property-test modules collect (and their
non-property tests run) when `hypothesis` is not installed: the property
tests themselves become individually-skipped stubs, and stay real property
tests whenever the dependency exists.
"""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; a fixture skips it where none is")


class _StubStrategies:
    """Accepts any strategy construction; the result is never executed."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def hypothesis_or_stub():
    """Returns (given, settings, st) — real hypothesis or skipping stubs."""
    try:
        from hypothesis import given, settings, strategies as st
        return given, settings, st
    except ImportError:
        pass

    def given(*args, **kwargs):
        def deco(fn):
            def stub():
                pytest.skip("hypothesis not installed")
            stub.__name__ = fn.__name__
            stub.__doc__ = fn.__doc__
            return stub
        return deco

    def settings(*args, **kwargs):
        return lambda fn: fn

    return given, settings, _StubStrategies()

"""Every test runs with a TMPDIR of its own: the harness writes its case
there and refuses to run without one."""

import pytest


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))

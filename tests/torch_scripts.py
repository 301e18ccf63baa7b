"""The port's command-line scripts as modules, for tests that call their
``main(argv)`` in process (``scripts/`` is not a package)."""

import importlib.util
import pathlib

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def load_script(name: str):
    """``scripts/<name>.py``, executed as a fresh module."""
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

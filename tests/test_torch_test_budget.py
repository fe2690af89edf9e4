"""The PyTorch port's tests keep to their time budget (``ROADMAP.md``'s
ground rules): read with ``ast``, nothing run.

* every ``spawn`` of a ``tests/test_torch_*.py`` file names its own
  ``timeout=`` (a hung gloo group fails its own test, not the suite's clock),
  and a file spawns one group a world size (a spawn takes a list of jobs);
* every ``subprocess.run`` / ``check_call`` / ``check_output`` of a port
  test (``tests/test_torch_*.py``, ``tests/torch_*.py``) names a ``timeout=``;
* every ``tests/test_torch_*.py`` that imports torch, the port or a port
  test helper imports ``torch_threads`` (one torch thread a test process)
  at module level.

``tests/test_torch_convert.py`` is the JAX package's own test of its
``utils/torch_convert.py``, older than the port: it is not held here.
"""

import ast
import functools
from pathlib import Path

TESTS = Path(__file__).resolve().parent
SUBPROCESS_CALLS = ("run", "check_call", "check_output")
NOT_PORT = {"test_torch_convert.py"}
# what a file imports that runs torch: torch, the port, the port's helpers
TORCH_MODULES = {"torch", "syncvsr_tpu_torch", "torch_parity", "torch_multiproc",
                 "torch_f64_frames", "chip_smoke"}


def _port_files(pattern="test_torch_*.py"):
    return sorted(p for p in TESTS.glob(pattern) if p.name not in NOT_PORT)


@functools.lru_cache(maxsize=None)
def _parse(source):
    return ast.parse(source)


def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _has_timeout(call):
    return any(k.arg == "timeout" for k in call.keywords)


def spawns_without_timeout(source, name="<src>"):
    """``name:line`` of every ``spawn(...)`` / ``x.spawn(...)`` call with no
    ``timeout=``."""
    out = []
    for call in _calls(_parse(source)):
        f = call.func
        callee = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        if callee == "spawn" and not _has_timeout(call):
            out.append(f"{name}:{call.lineno}")
    return out


def repeated_worlds(source, name="<src>"):
    """``name:line`` of every ``spawn`` after a file's first whose world
    size (its second argument) is not a literal, or is one an earlier
    ``spawn`` of the file has."""
    out, seen = [], set()
    for call in sorted(_calls(_parse(source)), key=lambda c: (c.lineno, c.col_offset)):
        f = call.func
        callee = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        if callee != "spawn" or len(call.args) < 2:
            continue
        world = call.args[1]
        world = world.value if isinstance(world, ast.Constant) else None
        if seen and (world is None or world in seen or None in seen):
            out.append(f"{name}:{call.lineno}")
        seen.add(world)
    return out


def subprocess_without_timeout(source, name="<src>"):
    """``name:line`` of every ``subprocess.run/check_call/check_output``
    call with no ``timeout=``."""
    out = []
    for call in _calls(_parse(source)):
        f = call.func
        if (isinstance(f, ast.Attribute) and f.attr in SUBPROCESS_CALLS
                and isinstance(f.value, ast.Name) and f.value.id == "subprocess"
                and not _has_timeout(call)):
            out.append(f"{name}:{call.lineno}")
    return out


def _imported(nodes):
    """Every component of every module the import statements among
    ``nodes`` name (``from tests.torch_parity import tt``: tests,
    torch_parity)."""
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                names |= set(a.name.split("."))
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names |= set(node.module.split("."))
    return names


def misses_thread_cap(source):
    """A file that imports torch, the port or a port helper anywhere, but
    not ``torch_threads`` at module level."""
    tree = _parse(source)
    return (bool(TORCH_MODULES & _imported(ast.walk(tree)))
            and "torch_threads" not in _imported(tree.body))


def test_every_spawn_has_its_own_timeout():
    bad = [hit for path in _port_files()
           for hit in spawns_without_timeout(path.read_text(), path.name)]
    assert not bad, bad


def test_one_spawn_a_world_size_a_file():
    bad = [hit for path in _port_files()
           for hit in repeated_worlds(path.read_text(), path.name)]
    assert not bad, bad


def test_every_port_subprocess_has_a_timeout():
    bad = [hit for path in _port_files() + _port_files("torch_*.py")
           for hit in subprocess_without_timeout(path.read_text(), path.name)]
    assert not bad, bad


def test_every_torch_test_file_caps_its_threads():
    files = _port_files()
    assert len(files) > 40
    bad = [path.name for path in files if misses_thread_cap(path.read_text())]
    assert not bad, bad


def test_the_checks_catch_what_they_forbid():
    src = ("import subprocess\nimport torch\n"
           "def f(tmp):\n"
           "    spawn(job, 2, tmp)\n"
           "    spawn(job, 2, tmp, timeout=60)\n"
           "    mp.spawn(g, nprocs=2)\n"
           "    subprocess.run(['x'], check=True)\n"
           "    subprocess.check_call(['x'], timeout=5)\n"
           "    subprocess.check_output(['x'])\n")
    assert spawns_without_timeout(src) == ["<src>:4", "<src>:6"]
    assert repeated_worlds(src) == ["<src>:5"]
    assert repeated_worlds("spawn(a, 2, t)\nspawn(b, 4, t)\n") == []
    assert repeated_worlds("spawn(a, seq, t)\nspawn(b, 4, t)\n") == ["<src>:2"]
    assert subprocess_without_timeout(src) == ["<src>:7", "<src>:9"]
    assert misses_thread_cap(src)
    assert not misses_thread_cap("import torch_threads  # noqa: F401\nimport torch\n")
    assert misses_thread_cap("import torch\ndef f():\n    import torch_threads\n")
    assert not misses_thread_cap("import numpy\n")
    assert misses_thread_cap("def f():\n    from torch import nn\n")
    assert misses_thread_cap("from tests.torch_parity import tt\n")
    assert not misses_thread_cap("from tests.torch_parity import tt\nimport torch_threads\n")

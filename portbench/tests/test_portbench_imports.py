"""Nothing the benchmark runs on the card imports JAX or the JAX package,
compared by whole top-level module names, and the reference imports
nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "dynhor_tpu"}


def _modules():
    out = []
    for dirpath, _, files in os.walk(H.HERE):
        if "tests" in os.path.relpath(dirpath, H.HERE).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return out


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_by_name():
    for path in _modules():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(H.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] not in FORBIDDEN | {"dynhor_tpu_torch", "portbench"}, (f, name)


def test_importing_the_harness_and_the_program_loads_no_jax():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import importlib, os, glob\n"
        "import portbench.run, portbench.harness, portbench.control, portbench.faults, portbench.scene, portbench.trace\n"
        "for p in glob.glob('portbench/*/*.py'):\n"
        "    if '/tests/' in p or p.endswith('__init__.py'): continue\n"
        "    if '/metrics/' in p: portbench.harness.load_reader(os.path.basename(p)[:-3]); continue\n"
        "    importlib.import_module(p[:-3].replace('/', '.'))\n"
        "import dynhor_tpu_torch.tracker.refine, dynhor_tpu_torch.tracker.priors, dynhor_tpu_torch.neus.trainer\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "print(sorted(new & {'jax', 'jaxlib', 'flax', 'dynhor_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

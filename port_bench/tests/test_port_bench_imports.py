"""What a run loads: nothing whose top-level module name is jax, jaxlib,
flax or lightzero_tpu (compared whole: lightzero_tpu_torch is the program),
and the references load nothing of the program."""
import json
import subprocess
import sys

from conftest import ROOT

RUN_CLOSURE = """
import json, sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import runpy
run = runpy.run_path({root!r} + "/port_bench/run.py", run_name="not_main")
from port_bench import harness
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.make_cell(spec, w["name"], 1, 1.0, False, "cpu")
    for m in harness.per_layer_for(spec, w["name"]):
        harness.reader(m["name"])
    import importlib
    importlib.import_module("port_bench.reference." + cell.config["family"])
# what the drivers import when they build the program
import lightzero_tpu_torch.policy, lightzero_tpu_torch.policy.unizero
import lightzero_tpu_torch.search.puct
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_CLOSURE = """
import json, sys, pkgutil, importlib
sys.path.insert(0, {root!r})
import port_bench.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("port_bench.reference." + m.name)
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return {name.split(".")[0] for name in json.loads(out.stdout.strip().splitlines()[-1])}


def test_run_loads_no_jax_nor_the_jax_package():
    tops = loaded(RUN_CLOSURE)
    assert "lightzero_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "lightzero_tpu"}, sorted(tops)


def test_references_load_nothing_of_the_program():
    tops = loaded(REFERENCE_CLOSURE)
    assert not tops & {"jax", "jaxlib", "flax", "lightzero_tpu", "lightzero_tpu_torch"}, sorted(tops)


def test_harness_finds_forbidden_names_whole():
    from port_bench import harness

    sys.modules.setdefault("lightzero_tpu_torch_probe_not_forbidden", sys)
    assert "lightzero_tpu_torch_probe_not_forbidden" not in harness.forbidden_loaded()
    assert all(n.split(".")[0] in harness.FORBIDDEN_MODULES for n in harness.forbidden_loaded())

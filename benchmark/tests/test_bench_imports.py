"""Nothing a run loads is JAX or the JAX package (compared by whole top-level
names), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from benchmark.tests.tiny import ROOT

RUN = '''
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.harness import forbidden_modules
from benchmark.tests.tiny import run_tiny
r = run_tiny("g_mdm_l.train_fused", trace=True)
print(json.dumps({"bad": forbidden_modules(), "port": "oakink2_tamf_tpu_torch" in sys.modules,
                  "correct": r["correct"]}))
'''

REFERENCE = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.diffusion, benchmark.reference.geometry, benchmark.reference.losses
import benchmark.reference.mano, benchmark.reference.mdm_g, benchmark.reference.refine_net
import benchmark.reference.steps, benchmark.reference.transforms, benchmark.reference.trunk
import benchmark.lib.assets, benchmark.lib.compare, benchmark.lib.segments, benchmark.lib.weights
import benchmark.lib.work, benchmark.lib.trace, benchmark.lib.seeds, benchmark.lib.peaks
from benchmark.harness import FORBIDDEN
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & (set(FORBIDDEN) | {"oakink2_tamf_tpu_torch"}))))
'''


def _last_json(script: str):
    out = subprocess.run([sys.executable, "-c", script, ROOT], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_rehearsal_run_loads_no_jax_nor_the_jax_package():
    got = _last_json(RUN)
    assert got["port"] and got["bad"] == []


def test_the_reference_and_the_yardstick_load_nothing_of_the_program():
    assert _last_json(REFERENCE) == []

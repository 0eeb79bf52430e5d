"""Time phase 5 of chip_smoke.py (K3, K4, K5 against their plain versions)
from several checkouts, in turns on one card, and compare the SASS that each
checkout's build gives each kernel.

From the root of a checkout, on a machine with an H100 and the CUDA toolkit,
with the checkouts to compare unpacked (git archive) in ignored directories:

    python3 -m refnerf_tpu_torch.tools.ab_trees --arm p=_chip/p \\
        --arm c=_chip/c --order p,c,p,c,p,c --out chiprun_out/ab

First every checkout builds its kernels into its own build/, all at once.
Then each run of --order (none without it) is a process of its own in its
checkout's root: it imports that checkout's chip_smoke.py and runs its
check_train_kernels. Each run's output goes to --out. Printed: every case's
kernel and plain times per arm in run order and their medians; then, per
library, whether each kernel instance of the first arm has the same SASS
instructions in each other arm (an instance that gained trailing template
flags, all false, is the same instance).
"""

import argparse
import difflib
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

RUN = '''
import sys, torch
sys.path.insert(0, '.')
import chip_smoke
from refnerf_tpu_torch.ops import fused_mlp
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.check_train_kernels(fused_mlp, torch.device('cuda'))
'''
BUILD = 'from refnerf_tpu_torch.ops import cuda_build; cuda_build.build()'
FALSE = ('false', '(bool)0')  # a false template flag, as cu++filt prints it
TIMES = re.compile(r'^phase \d+: (\S+) (float32|bfloat16) N=\d+: .*?kernel '
                   r'([\d.]+) ms, plain ([\d.]+) ms', re.M)
SASS = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(.*?;)')
NAME = re.compile(r'(\w+)<(.*)>\(')


def cuda_tool(name):
  found = shutil.which(name) or f'/usr/local/cuda/bin/{name}'
  if not pathlib.Path(found).exists():
    raise RuntimeError(f'{name} not found (PATH, /usr/local/cuda/bin)')
  return found


def build(arms):
  """Every arm's kernels, built at once (one nvcc per source and arm)."""
  procs = {arm: subprocess.Popen([sys.executable, '-c', BUILD], cwd=root,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
           for arm, root in arms.items()}
  for arm, proc in procs.items():
    log = proc.communicate(timeout=1200)[0]
    if proc.returncode != 0:
      raise RuntimeError(f'{arm}: the build exited {proc.returncode}:\n'
                         f'{log[-3000:]}')


def run_arms(arms, order, out):
  """{(case, dtype): {arm: [(kernel ms, plain ms) per run]}}."""
  times = {}
  for i, arm in enumerate(order):
    proc = subprocess.run([sys.executable, '-c', RUN],
                          cwd=arms[arm], capture_output=True, text=True,
                          timeout=1200)
    (out / f'run{i}_{arm}.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
      raise RuntimeError(f'run {i} ({arm}) exited {proc.returncode}:\n'
                         f'{proc.stderr[-3000:]}')
    for case, cdt, k, p in TIMES.findall(proc.stdout):
      times.setdefault((case, cdt), {}).setdefault(arm, []).append(
          (float(k), float(p)))
    print(f'run {i} ({arm}) done', flush=True)
  return times


def functions(lib):
  """{(kernel name, template arguments): SASS instructions} of a library."""
  text = subprocess.run([cuda_tool('cuobjdump'), '-sass', str(lib)],
                        capture_output=True, text=True, check=True).stdout
  blocks = re.split(r'\n\s*Function : (\S+)\n', text)
  names = blocks[1::2]
  plain = subprocess.run([cuda_tool('cu++filt')], input='\n'.join(names),
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
  found = {}
  for name, body in zip(plain, blocks[2::2]):
    m = NAME.search(name)
    key = (m.group(1), tuple(m.group(2).split(', '))) if m else (name, ())
    found[key] = SASS.findall(body)
  return found


def same_instance(key, others):
  """The key in `others` that names the same instance as `key`."""
  name, args = key
  for other in others:
    if other[0] != name:
      continue
    a, b = (args, other[1]) if len(args) <= len(other[1]) else (other[1], args)
    if b[:len(a)] == a and all(x in FALSE for x in b[len(a):]):
      return other
  return None


def compare_sass(arms, out):
  """Per library and kernel instance of the first arm: 'same' or the
  number of differing instruction lines against each other arm."""
  first, *rest = arms
  report = {}
  for lib in sorted((arms[first] / 'build' / 'refnerf_tpu_torch').glob('*.so')):
    stem = lib.name.rsplit('_', 1)[0]
    base = functions(lib)
    for arm in rest:
      libs = list((arms[arm] / 'build' / 'refnerf_tpu_torch').glob(
          stem + '_*.so'))
      if len(libs) != 1:
        raise RuntimeError(f'{arm}: {len(libs)} builds of {stem}')
      other = functions(libs[0])
      for key, code in base.items():
        match = same_instance(key, other)
        label = f'{stem} {key[0]}<{", ".join(key[1])}>'
        if match is None:
          verdict = f'not in {arm}'
        elif other[match] == code:
          verdict = f'same SASS in {arm} ({len(code)} instructions)'
        else:
          diff = [l for l in difflib.unified_diff(code, other[match], n=0,
                                                  lineterm='')
                  if l[:1] in '+-' and l[:3] not in ('+++', '---')]
          name = re.sub(r'\W+', '_', label).strip('_')
          (out / f'sass_{arm}_{name}.diff').write_text('\n'.join(diff))
          verdict = (f'differs in {arm}: {len(code)} vs '
                     f'{len(other[match])} instructions, {len(diff)} lines')
        report.setdefault(label, []).append(verdict)
  return report


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--arm', action='append', required=True,
                  help='name=checkout directory; the first is the base')
  ap.add_argument('--order', default='',
                  help='arm names, comma-separated (none: only the SASS)')
  ap.add_argument('--out', default='chiprun_out/ab')
  a = ap.parse_args()
  arms = {k: pathlib.Path(v).resolve()
          for k, v in (s.split('=', 1) for s in a.arm)}
  order = a.order.split(',') if a.order else []
  if order and set(order) != set(arms):
    raise SystemExit('--order must name every arm')
  out = pathlib.Path(a.out)
  out.mkdir(parents=True, exist_ok=True)
  build(arms)
  times = run_arms(arms, order, out)
  summary = {}
  for (case, cdt), by_arm in times.items():
    row = {}
    for arm, runs in by_arm.items():
      ks, ps = [r[0] for r in runs], [r[1] for r in runs]
      row[arm] = {'kernel_ms': ks, 'plain_ms': ps,
                  'kernel_median': statistics.median(ks),
                  'plain_median': statistics.median(ps)}
      print(f'{case} {cdt} {arm}: kernel ' + ' '.join(f'{k:.3f}' for k in ks)
            + f' (median {row[arm]["kernel_median"]:.3f}) ms, plain '
            + ' '.join(f'{p:.3f}' for p in ps)
            + f' (median {row[arm]["plain_median"]:.3f}) ms')
    summary[f'{case} {cdt}'] = row
  sass = compare_sass(arms, out)
  for label, verdicts in sass.items():
    print(f'{label}: {"; ".join(verdicts)}')
  (out / 'summary.json').write_text(json.dumps(
      {'order': order, 'times': summary, 'sass': sass},
      indent=1))
  return 0


if __name__ == '__main__':
  sys.exit(main())

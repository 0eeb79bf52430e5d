"""Minimal HTTP serving host for a serving artifact, on the standard library
(counterpart of tools/serve_http.py).

Serves a weight-embedded `torch.export` artifact (refnerf_tpu_torch/
serving.py) over HTTP, with no framework on the host beyond torch, numpy
and this package:

    python3 -m refnerf_tpu_torch.tools.serve_http scene.rnsrv \
        [--host 0.0.0.0] [--port 8080]

Endpoints:
  GET  /health  -> {"ok": true}
  GET  /meta    -> artifact metadata (chunk size, buffers, platforms)
  POST /render  -> JSON {"origins": [N,3], "directions": [N,3],
                   optional "viewdirs" [N,3] (defaults to normalized
                   directions), "radii" [N,1]|scalar (default 0.001),
                   "near"/"far" [N,1]|scalar (default artifact metadata),
                   optional "buffers": [names]}
               -> JSON {buffer: nested lists} for the requested buffers
                  (default: rgb, acc, distance_mean when present)

Arbitrary N: rays pad onto the artifact's fixed-chunk program. Requests
serialize through one lock - the device program is single-stream anyway;
run replicas for scale-out. A CUDA artifact builds its kernels when the
server is made, before the first request.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from refnerf_tpu_torch import serving
from refnerf_tpu_torch.cameras import rays as rays_lib

_DEFAULT_BUFFERS = ('rgb', 'acc', 'distance_mean')
_WARNED_BOUNDS = []


def _render(served, req):
  origins = np.asarray(req['origins'], np.float32)
  directions = np.asarray(req['directions'], np.float32)
  if origins.ndim != 2 or origins.shape[-1] != 3:
    raise ValueError(f'origins must be [N, 3], got {origins.shape}')
  if directions.shape != origins.shape:
    raise ValueError('directions must match origins shape')
  n = origins.shape[0]

  def col(name, default):
    v = req.get(name, default)
    arr = np.asarray(v, np.float32)
    return np.broadcast_to(arr.reshape(-1, arr.shape[-1] if arr.ndim > 1
                                       else 1), (n, 1)).copy()

  if 'viewdirs' in req:
    viewdirs = np.asarray(req['viewdirs'], np.float32)
  else:
    viewdirs = directions / np.maximum(
        np.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)

  if ('near' not in served.meta and 'near' not in req
      and not _WARNED_BOUNDS):
    _WARNED_BOUNDS.append(True)
    print('WARNING: neither the artifact metadata (pre-near/far exports) '
          'nor the request specifies near/far; defaulting to [0.1, 100] - '
          'pass them explicitly for correct sampling bounds')
  meta_near = float(served.meta.get('near', 0.1))
  meta_far = float(served.meta.get('far', 100.0))
  fields = dict(
      origins=origins, directions=directions, viewdirs=viewdirs,
      radii=col('radii', 0.001), lossmult=np.ones((n, 1), np.float32),
      near=col('near', meta_near), far=col('far', meta_far))
  rays = rays_lib.Rays(**{**vars(rays_lib.dummy_rays(n)),
                          **{k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in fields.items()}})
  # serve_image treats the leading two axes as a frame: [N, 1] here (it
  # handles the pad onto the artifact's fixed chunk).
  out = served.serve_image(rays.reshape(n, 1))

  names = req.get('buffers')
  if names is None:
    names = [b for b in _DEFAULT_BUFFERS if b in out]
  missing = [b for b in names if b not in out]
  if missing:
    raise ValueError(f'unknown buffers {missing}; have {sorted(out)}')
  return {b: np.asarray(out[b])[:, 0].tolist() for b in names}


def make_server(artifact_path, host='127.0.0.1', port=0):
  """Build (but don't run) the HTTP server; .server_port is bound."""
  served = serving.load_serving(artifact_path)
  lock = threading.Lock()

  class Handler(BaseHTTPRequestHandler):

    def _send(self, code, payload):
      body = json.dumps(payload).encode('utf-8')
      self.send_response(code)
      self.send_header('Content-Type', 'application/json')
      self.send_header('Content-Length', str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def do_GET(self):
      if self.path == '/health':
        self._send(200, {'ok': True})
      elif self.path == '/meta':
        self._send(200, served.meta)
      else:
        self._send(404, {'error': f'unknown path {self.path}'})

    def do_POST(self):
      if self.path != '/render':
        self._send(404, {'error': f'unknown path {self.path}'})
        return
      try:
        length = int(self.headers.get('Content-Length', 0))
        req = json.loads(self.rfile.read(length) or b'{}')
        with lock:
          out = _render(served, req)
        self._send(200, out)
      except (ValueError, KeyError, TypeError) as e:
        self._send(400, {'error': str(e)})

    def log_message(self, fmt, *args):  # quiet: one line per request
      print(f'{self.command} {self.path} {args[1] if len(args) > 1 else ""}')

  return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('artifact')
  p.add_argument('--host', default='127.0.0.1')
  p.add_argument('--port', type=int, default=8080)
  args = p.parse_args(argv)
  server = make_server(args.artifact, args.host, args.port)
  print(f'serving {args.artifact} on http://{args.host}:'
        f'{server.server_port}')
  server.serve_forever()


if __name__ == '__main__':
  main()

"""The port's HTTP serving host (refnerf_tpu_torch/tools/serve_http.py):
JAX's four cases of tests/test_serve_http.py (the endpoints, the pad onto
the chunk program against a direct call, the defaults and the buffer
selection, the errors: 400 with the message, 404 on an unknown path), and
its /render against JAX's host (tools/serve_http.py) on the same weights
(JAX's `_TINY` parameters carried across by `convert.load_jax_params`),
within 1e-5 (float32, as tests/test_torch_port_serving.py)."""

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from refnerf_tpu import serving as jserving
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import serving
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.tools import serve_http
from tests import test_serving as jtests
from tests.test_torch_port_serving import _port_rays

CHUNK = jtests.CHUNK
TOL = 1e-5


def _start(srv):
  t = threading.Thread(target=srv.serve_forever, daemon=True)
  t.start()
  return f'http://127.0.0.1:{srv.server_port}'


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
  """The port's and JAX's hosts of one model: (port url, JAX url, the
  port's artifact path)."""
  sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'tools'))
  import serve_http as jserve_http

  root = tmp_path_factory.mktemp('srv')
  jmodel, params = jtests._model_and_params()
  config, gin = configs.parse(None, [jtests._TINY])
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, jax.device_get(params))
  path, jpath = str(root / 'port.rnsrv'), str(root / 'jax.rnsrv')
  serving.export_serving(model, path, chunk=CHUNK, device='cpu')
  jserving.export_serving(jmodel, params, jpath, chunk=CHUNK,
                          platforms=('cpu',))
  srvs = [serve_http.make_server(path, port=0),
          jserve_http.make_server(jpath, port=0)]
  yield _start(srvs[0]), _start(srvs[1]), path
  for srv in srvs:
    srv.shutdown()
    srv.server_close()


def _get(url):
  with urllib.request.urlopen(url, timeout=60) as r:
    return json.loads(r.read())


def _post(url, payload):
  req = urllib.request.Request(
      url, data=json.dumps(payload).encode(), method='POST',
      headers={'Content-Type': 'application/json'})
  with urllib.request.urlopen(req, timeout=120) as r:
    return json.loads(r.read())


def _payload(rays, **extra):
  return {'origins': np.asarray(rays.origins).tolist(),
          'directions': np.asarray(rays.directions).tolist(),
          'viewdirs': np.asarray(rays.viewdirs).tolist(), **extra}


def test_health_and_meta(servers):
  base = servers[0]
  assert _get(base + '/health') == {'ok': True}
  meta = _get(base + '/meta')
  assert meta['chunk'] == CHUNK and 'rgb' in meta['buffers']
  assert meta['platforms'] == ['cpu']


def test_render_matches_direct_call(servers):
  base, _, path = servers
  n = CHUNK + 3  # exercises the pad onto the fixed-chunk program
  rays = jtests._rays(n)
  out = _post(base + '/render', _payload(rays, radii=0.01, near=0.5, far=3.0))
  rgb = np.asarray(out['rgb'], np.float32)
  assert rgb.shape == (n, 3)
  direct = serving.load_serving(path).serve_image(_port_rays(rays).reshape(
      n, 1))
  np.testing.assert_array_equal(rgb, direct['rgb'][:, 0])


def test_render_matches_the_jax_host(servers):
  base, jbase, _ = servers
  rays = jtests._rays(CHUNK + 5, seed=11)
  payload = _payload(rays, radii=0.01, near=0.5, far=3.0,
                     buffers=['rgb', 'acc', 'distance'])
  got, want = _post(base + '/render', payload), _post(jbase + '/render',
                                                      payload)
  assert set(got) == set(want) == {'rgb', 'acc', 'distance'}
  for k in want:
    np.testing.assert_allclose(np.asarray(got[k], np.float32),
                               np.asarray(want[k], np.float32), rtol=TOL,
                               atol=TOL, err_msg=k)


def test_render_defaults_and_buffer_selection(servers):
  base = servers[0]
  rays = jtests._rays(4, seed=9)
  out = _post(base + '/render', {
      'origins': np.asarray(rays.origins).tolist(),
      'directions': np.asarray(rays.directions).tolist(),
      'buffers': ['acc'],
  })  # viewdirs/radii/near/far all defaulted
  assert set(out) == {'acc'}
  assert np.isfinite(np.asarray(out['acc'], np.float32)).all()


def test_render_errors(servers):
  base = servers[0]
  with pytest.raises(urllib.error.HTTPError) as e:
    _post(base + '/render', {'origins': [[0, 0]], 'directions': [[0, 0]]})
  assert e.value.code == 400
  assert 'origins' in json.loads(e.value.read())['error']

  with pytest.raises(urllib.error.HTTPError) as e:
    _post(base + '/render', {
        'origins': [[0., 0., 0.]], 'directions': [[1., 0., 0.]],
        'buffers': ['nope']})
  assert e.value.code == 400

  with pytest.raises(urllib.error.HTTPError) as e:
    _get(base + '/nothere')
  assert e.value.code == 404

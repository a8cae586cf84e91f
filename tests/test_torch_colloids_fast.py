"""The port's colloid steps on the JAX package's suspension routes, on the
CPU: n = 6 particles at 16^3, 4 steps each, against ludwig_tpu's
make_colloid_step run op by op (the chains of test_torch_colloids.py).

float64 takes the JAX package's batched exact route (build_map_fast,
remove_replace_seeds_fast, bbl_step_exact), which the port's
reference-order route holds bitwise; float32 the segment-sum route
(bbl_step_mxu semantics, passive, squirmers and walls), held at rtol
1e-5 / atol 1e-6 of the JAX float32 route, the map identical."""

import numpy as np
import pytest

from test_torch_colloids import F32, assert_bitwise, run_chains

CHAINS = {"f64-n6-exact": (6, "float64", 1, None, False, "ordered"),
          "f32-n6-passive-rebuild2": (6, "float32", 2, None, False,
                                      "segment"),
          "f32-n6-squirmers": (6, "float32", 1, None, True, "segment"),
          "f32-n6-walls": (6, "float32", 1, (True, False, False), False,
                           "segment")}


@pytest.mark.parametrize("name", list(CHAINS))
def test_suspension_chain(name):
    n, dtype, rf, walls, active, route = CHAINS[name]
    js, ts, tstep = run_chains(n, dtype, rf, walls, active)
    assert tstep.route == route
    assert_bitwise(js.pmap[1], ts.pmap[1])
    for i in range(7):
        if dtype == "float64":
            assert_bitwise(js[i], ts[i])
        else:
            np.testing.assert_allclose(ts[i].numpy(), np.asarray(js[i]),
                                       **F32)
    if walls:
        np.testing.assert_allclose(ts.gwall.numpy(), np.asarray(js.gwall),
                                   rtol=1e-5, atol=1e-6)

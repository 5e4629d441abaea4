"""The port's DST sweep under each lever against the JAX package's: the
tiled log, banded peer counts and the role-sparse slab, each at the
configuration of the JAX package's own lever cross-checks
(tests/test_raft_sim.py TestTiledLog / TestTiledPeer / TestSparseProgress
test_dst_cross_check_equal_bitmasks), cut to 16 schedules x 60 ticks.

JAX's make_batch schedules are carried across with
FaultSchedule.from_numpy and run through both packages' explore: the
violation masks, first violating ticks, per-tick masks and every final
field must be equal (integers and bools: exact), and zero violations.
The port runs each lever on its batch-native tick, so this is the
batched lever against JAX's vmap of it.
"""

from __future__ import annotations

import numpy as np
import pytest

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import jax_numpy

CPU = "cpu"
S, T = 16, 60
BASE5 = dict(n=5, log_len=512, window=8, apply_batch=16, max_props=8,
             keep=4, election_tick=10, seed=77)
BASE16 = dict(BASE5, n=16, log_len=64)
LEVERS = {
    "log_chunk=128": dict(BASE5, log_chunk=128),
    "peer_chunk=8": dict(BASE16, peer_chunk=8),
    "active_rows=8": dict(BASE16, active_rows=8),
}


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_explore_under_lever_equals_jax(lever):
    kw = LEVERS[lever]
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    assert tcfg.tiled or tcfg.peer_tiled or tcfg.active_rows_on
    jb, names = jdst.make_batch(jcfg, ticks=T, schedules=S, seed=9)
    jres = jdst.explore(jstate.init_state(jcfg), jcfg, jb, profiles=names)
    tb = tdst.FaultSchedule.from_numpy(jb, device=CPU)
    tkernel.reset_counts()
    tres = tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, tb,
                        profiles=names, device=CPU)
    assert np.array_equal(tres.viol, np.asarray(jres.viol))
    assert np.array_equal(tres.first_tick, np.asarray(jres.first_tick))
    assert np.array_equal(tres.bits_by_tick, np.asarray(jres.bits_by_tick))
    assert tres.violating.size == 0, [
        tdst.bits_to_names(int(tres.viol[s])) for s in tres.violating]
    want = jax_numpy(jres.final_state)
    got = tstate.state_to_numpy(tres.final_state)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        assert np.array_equal(got[name], w), name
    # the lever really ran under the batch axis: the tiled log and the slab
    # read the batch's band or fit once a tick, the banded counts none
    syncs = tkernel.COUNTS["host_syncs"]
    if tcfg.tiled or tcfg.active_rows_on:
        assert syncs == T, syncs
    else:
        assert syncs == 0, syncs
    if tcfg.active_rows_on:
        assert tkernel.COUNTS["slab_ticks"] > 0

"""Fixed proof shapes: the port's ``ShapeConfig`` against the reference's, and
one core-config proof (shapes on) of a small fib guest, equal to the reference
package's bit for bit (tolerance 0)."""

import numpy as np
import pytest

from zkmips_tpu.executor import execute_for_proving as j_execute_for_proving
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.machine import shapes as jshapes
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import asm, execute_for_proving
from zkmips_tpu_torch.machine import shapes
from zkmips_tpu_torch.machine.machine import MipsMachine, mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_executor import JAX_SIDE, PORT_SIDE, fib_body
from test_torch_stark import _assert_same


def test_lattice_and_menu_match():
    assert shapes.LATTICE == jshapes.LATTICE
    for rows in list(range(0, 70)) + [1 << k for k in range(4, 24)] + [(1 << k) + 1 for k in range(4, 24)]:
        assert shapes.lattice_log(rows) == jshapes.lattice_log(rows), rows
    menu, jmenu = shapes.load_menu(), jshapes.load_menu()
    assert len(menu) == len(jmenu) > 0
    assert [s.log_heights for s in menu] == [s.log_heights for s in jmenu]
    cfg, jcfg = shapes.ShapeConfig(), jshapes.ShapeConfig()
    for rows in (1, 16, 17, 100, 5000, 70000):
        assert cfg.fix_preprocessed_rows(rows) == jcfg.fix_preprocessed_rows(rows)


def test_fix_shape_matches_on_seeded_heights():
    rng = np.random.default_rng(5)
    names = ["Cpu", "AddSub", "Bitwise", "Branch", "MemoryLocal", "Global", "Program", "Byte"]
    cfg, jcfg = shapes.ShapeConfig(), jshapes.ShapeConfig()
    for _ in range(200):
        k = int(rng.integers(2, len(names) + 1))
        picked = list(rng.choice(names, size=k, replace=False))
        heights = {n: int(2 ** rng.uniform(0, 21)) for n in picked}
        widths = {n: int(rng.integers(1, 80)) for n in picked}
        got, ref = cfg.fix_shape(heights, widths), jcfg.fix_shape(heights, widths)
        assert got.log_heights == ref.log_heights
        assert all((1 << got.log_h(n)) >= h for n, h in heights.items())
    assert (getattr(cfg, "menu_hits", 0), cfg.menu_misses) == \
        (getattr(jcfg, "menu_hits", 0), jcfg.menu_misses)


def test_shapes_default_on_at_the_core_config_only():
    assert mips_machine(StarkConfig.core(), minimal=True).machine.shape_config is not None
    assert mips_machine(StarkConfig.test(), minimal=True).machine.shape_config is None
    from zkmips_tpu_torch.machine.machine import core_chip_airs

    assert MipsMachine(StarkConfig.test(), core_chip_airs(), use_shapes=True).machine.shape_config is not None


def test_core_config_proof_with_shapes_equals_the_reference():
    n_iters = 5
    jp = jasm.prog(fib_body(JAX_SIDE, n_iters) + jasm.halt_sequence())
    tp = asm.prog(fib_body(PORT_SIDE, n_iters) + asm.halt_sequence())
    jrecords, _ = j_execute_for_proving(jp)
    trecords, _ = execute_for_proving(tp)
    jm = j_mips_machine(jmachine.StarkConfig.core(), minimal=True)
    tm = mips_machine(StarkConfig.core(), minimal=True)
    jpk, tpk = jm.setup(jp), tm.setup(tp, device="cpu")
    (jproof,) = jm.prove(jpk, jrecords, device=False)
    (tproof,) = tm.prove(tpk, trecords, device="cpu")
    # 39 Cpu rows: the lattice pads them to 2^6, where plain padding gives 2^6
    # too, but the 5-row chips go to the lattice's 2^4 and Global to 2^6
    heights = dict(zip(tproof.chip_names, (o.log_degree for o in tproof.opened)))
    assert all(lg in shapes.LATTICE for lg in heights.values()), heights
    assert heights["Cpu"] == 6 and heights["Global"] == 6 and heights["Byte"] == 16
    converted = convert.shard_proof_to_reference(tproof, jmachine, jpcs)
    _assert_same(converted, jproof)
    assert jm.verify(jpk.vk, [converted], jp)
    assert tm.verify(tpk.vk, [tproof], tp)

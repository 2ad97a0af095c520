"""The board cell (`trellis_1k.board_merge`) in the benchmark's own suite:
its CPU test size, registered beside the other cells' in conftest's
tables when this module is collected, so that the tests parametrised
over every cell (`test_cpu_run_is_correct_with_the_contract_keys`,
`test_control_fails`) run it at that size. The board's own tests are in
tests/test_torch_board.py."""

import conftest
from conftest import small_cell

conftest.SMALL_CONFIG.setdefault("trellis_1k", {"actors": 60, "cards": 4})
conftest.SMALL_TRAFFIC.setdefault("board_merge", {})


def test_the_board_cell_has_a_cpu_size():
    from portbench.families import board_merge
    c = small_cell("trellis_1k.board_merge")
    gen = board_merge.Board(c.config, 5)
    assert (gen.n_actors, gen.n_cards, gen.n_tasks) == (60, 4, 3)
    # 20 appends of 2 ops, 20 retitles and 20 deletes of 1
    assert gen.n_ops == 20 * 2 + 20 + 20

"""The sync server's cell (`rooms_100x10.typing_rounds`) in the benchmark's
own suite: its CPU test size, registered beside the other cells' in
conftest's tables when this module is collected, so that the tests
parametrised over every cell (`test_cpu_run_is_correct_with_the_contract_keys`,
`test_control_fails`) run it at that size. The cell's own tests are in
tests/test_torch_sync_rooms.py."""

import conftest
from conftest import small_cell

conftest.SMALL_CONFIG.setdefault("rooms_100x10",
                                 {"rooms": 3, "peers_per_room": 4})
conftest.SMALL_TRAFFIC.setdefault("typing_rounds", {})


def test_the_rooms_cell_has_a_cpu_size():
    from portbench.families import sync_rounds
    c = small_cell("rooms_100x10.typing_rounds")
    gen = sync_rounds.Rooms(c.config, c.traffic, 5)
    assert (gen.n_rooms, gen.n_peers, gen.chars, gen.run) == (3, 4, 50, 4)
    assert gen.n_ops == 3 * 4 * 8

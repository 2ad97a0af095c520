"""The int32 envelope of the port against the JAX package's
(tests/test_int32_guards.py's six tests, run on both packages).

Both packages pack elemId keys as (actor_rank << 32 | ctr) int64 on the
host and store every device column as int32, so a counter, seq or rank
past 2^31 - 1, or negative, would wrap into a wrong order silently. Every
packing and encoding site must raise OverflowError instead, at the same
inputs and with the same message in both packages, and an in-envelope
batch must round-trip to the same document."""

import numpy as np
import pytest

import automerge_tpu._common as JC
import automerge_tpu.engine as JE
import automerge_tpu.engine.columnar as JCol
import automerge_tpu.engine.host_index as JH
import automerge_tpu_torch._common as TC
import automerge_tpu_torch.engine as TE
import automerge_tpu_torch.engine.columnar as TCol
import automerge_tpu_torch.engine.host_index as TH

INT32_MAX = JC.INT32_MAX
PKGS = {"jax": (JC, JH, JCol, lambda: JE.DeviceTextDoc("t")),
        "torch": (TC, TH, TCol, lambda: TE.DeviceTextDoc("t", device="cpu"))}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    """(the package's _common, host_index, columnar, a text-doc maker)."""
    return PKGS[request.param]


def test_check_int32_envelope_bounds(pkg):
    C = pkg[0]
    assert C.INT32_MAX == INT32_MAX
    C.check_int32_envelope("x", np.asarray([0, 1, INT32_MAX]))
    with pytest.raises(OverflowError, match="envelope"):
        C.check_int32_envelope("x", np.asarray([INT32_MAX + 1]))
    with pytest.raises(OverflowError, match="envelope"):
        C.check_int32_envelope("x", np.asarray([-1]))
    C.check_int32_envelope("x", np.empty(0, np.int64))     # empty: no-op


def test_pack_keys_rejects_overflowing_ctr(pkg):
    pack_keys = pkg[1].pack_keys
    ok = pack_keys(np.asarray([1, 2]), np.asarray([5, INT32_MAX]))
    assert ok.dtype == np.int64
    with pytest.raises(OverflowError, match="elemId counter"):
        pack_keys(np.asarray([1]), np.asarray([INT32_MAX + 1]))
    with pytest.raises(OverflowError, match="elemId counter"):
        pack_keys(np.asarray([1]), np.asarray([-7]))
    with pytest.raises(OverflowError, match="actor rank"):
        pack_keys(np.asarray([-2]), np.asarray([1]))


def test_pack_keys_boundary_does_not_collide(pkg):
    """Adjacent in-envelope keys stay distinct and ordered, the property
    a silent wrap would destroy."""
    keys = pkg[1].pack_keys(np.asarray([0, 0, 1]),
                            np.asarray([INT32_MAX - 1, INT32_MAX, 0]))
    assert len(set(keys.tolist())) == 3
    assert (np.diff(keys) > 0).all()


def test_text_batch_rejects_overflowing_elem_counter(pkg):
    """Wire changes minting an elemId counter past the envelope fail at
    batch construction, before anything reaches a device column."""
    TB = pkg[2].TextChangeBatch
    big = INT32_MAX + 1
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": big}]}]
    with pytest.raises(OverflowError, match="elemId counter"):
        TB.from_changes(changes, "t")
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": f"b:{big}", "elem": 1}]}]
    with pytest.raises(OverflowError, match="counter"):
        TB.from_changes(changes, "t")


def test_batches_reject_overflowing_seq(pkg):
    col = pkg[2]
    changes = [{"actor": "a", "seq": INT32_MAX + 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": 1}]}]
    with pytest.raises(OverflowError, match="seq"):
        col.TextChangeBatch.from_changes(changes, "t")
    mchanges = [{"actor": "a", "seq": INT32_MAX + 1, "deps": {}, "ops": [
        {"action": "set", "obj": "m", "key": "k", "value": 1}]}]
    with pytest.raises(OverflowError, match="seq"):
        col.MapChangeBatch.from_changes(mchanges, "m")
    zchanges = [{"actor": "a", "seq": 0, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": 1}]}]
    with pytest.raises(OverflowError, match="seq"):
        col.TextChangeBatch.from_changes(zchanges, "t")


def test_in_envelope_batch_still_round_trips(pkg):
    """The guard must not reject legitimate large-but-legal counters."""
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": INT32_MAX},
        {"action": "set", "obj": "t", "key": f"a:{INT32_MAX}",
         "value": "z"}]}]
    doc = pkg[3]()
    doc.apply_batch(pkg[2].TextChangeBatch.from_changes(changes, "t"))
    assert doc.text() == "z"
    assert doc.elem_ids() == [f"a:{INT32_MAX}"]


# ----------------------------------------------- the two packages side by side

def _raised(fn):
    try:
        fn()
    except OverflowError as e:
        return str(e)
    return None


EDGES = [-2**31 - 1, -2, -1, 0, 1, INT32_MAX - 1, INT32_MAX, INT32_MAX + 1,
         2**32, 2**40]


@pytest.mark.parametrize("value", EDGES)
def test_envelope_checks_raise_where_the_jax_package_does(value):
    """check_int32_envelope (both lower bounds) and pack_keys (either
    column) raise at the same values, with the same message."""
    arr = np.asarray([3, value], np.int64)
    for lo in (0, 1):
        assert _raised(lambda: TC.check_int32_envelope("col", arr, lo=lo)) \
            == _raised(lambda: JC.check_int32_envelope("col", arr, lo=lo))
    ones = np.ones(2, np.int64)
    for args in ((ones, arr), (arr, ones)):
        assert _raised(lambda: TH.pack_keys(*args)) \
            == _raised(lambda: JH.pack_keys(*args))
    if _raised(lambda: JH.pack_keys(ones, arr)) is None:
        np.testing.assert_array_equal(TH.pack_keys(ones, arr),
                                      JH.pack_keys(ones, arr))


@pytest.mark.parametrize("seq,elem,parent", [
    (1, INT32_MAX, "_head"), (INT32_MAX, 1, "_head"), (0, 1, "_head"),
    (INT32_MAX + 1, 1, "_head"), (1, INT32_MAX + 1, "_head"),
    (1, 1, f"b:{INT32_MAX + 1}"), (1, 1, f"b:{INT32_MAX}"), (-3, 1, "_head")])
def test_batch_builders_raise_where_the_jax_package_does(seq, elem, parent):
    """The text and map batch builders reject (or accept) the same wire
    changes as the JAX package's; accepted batches carry equal columns."""
    changes = [{"actor": "a", "seq": seq, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": parent, "elem": elem},
        {"action": "set", "obj": "t", "key": f"a:{elem}", "value": "q"}]}]
    mchanges = [{"actor": "a", "seq": seq, "deps": {}, "ops": [
        {"action": "set", "obj": "m", "key": "k", "value": elem}]}]
    for kind, ch, obj in (("TextChangeBatch", changes, "t"),
                          ("MapChangeBatch", mchanges, "m")):
        want = _raised(lambda: getattr(JCol, kind).from_changes(ch, obj))
        assert _raised(lambda: getattr(TCol, kind).from_changes(ch, obj)) \
            == want
        if want is None:
            a = getattr(JCol, kind).from_changes(ch, obj)
            b = getattr(TCol, kind).from_changes(ch, obj)
            for k in a.__dataclass_fields__:
                x, y = getattr(a, k), getattr(b, k)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(y, x, err_msg=k)
                    assert y.dtype == x.dtype, k
                else:
                    assert y == x, k


def test_in_envelope_documents_are_equal():
    """The largest legal counters give the same document in both packages:
    text, element ids and the live prefix of every table."""
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": INT32_MAX - 1},
        {"action": "set", "obj": "t", "key": f"a:{INT32_MAX - 1}",
         "value": "y"},
        {"action": "ins", "obj": "t", "key": f"a:{INT32_MAX - 1}",
         "elem": INT32_MAX},
        {"action": "set", "obj": "t", "key": f"a:{INT32_MAX}",
         "value": "z"}]},
        {"actor": "b", "seq": 1, "deps": {}, "ops": [
            {"action": "ins", "obj": "t", "key": "_head", "elem": 1},
            {"action": "set", "obj": "t", "key": "b:1", "value": "x"}]}]
    docs = []
    for name in ("jax", "torch"):
        _, _, col, make = PKGS[name]
        doc = make()
        doc.apply_batch(col.TextChangeBatch.from_changes(changes, "t"))
        docs.append(doc)
    jdoc, tdoc = docs
    assert tdoc.text() == jdoc.text() == "yzx"
    assert tdoc.elem_ids() == jdoc.elem_ids()
    live = jdoc.n_elems + 1
    for k in jdoc._TABLE_KEYS:
        np.testing.assert_array_equal(
            tdoc._ensure_dev()[k].numpy()[:live],
            np.asarray(jdoc._ensure_dev()[k])[:live], err_msg=k)

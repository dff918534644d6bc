"""The port's configs against the reference's, field by field: every
field the reference's dataclass has (nested ones included) equal, every
field only the port has (its "port only" fields) at its default."""

import dataclasses


def assert_same_fields(port, ref) -> None:
    for f in dataclasses.fields(port):
        mine = getattr(port, f.name)
        if not hasattr(ref, f.name):
            assert mine == f.default, (type(port).__name__, f.name)
        elif dataclasses.is_dataclass(mine):
            assert_same_fields(mine, getattr(ref, f.name))
        else:
            assert mine == getattr(ref, f.name), (type(port).__name__,
                                                  f.name)
    missing = {f.name for f in dataclasses.fields(ref)} - {
        f.name for f in dataclasses.fields(port)}
    assert not missing, missing

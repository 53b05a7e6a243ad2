"""The column table that replaced pandas on the simulation path, checked
against the DataFrame behaviour it stands in for, and the JSON
registries against the YAML reader that user configs still use."""

import json

import numpy as np
import pytest

from maria_tpu.utils.table import Table, concat, read_csv

pd = pytest.importorskip("pandas")


def _pair():
    cols = {"band_name": np.array(["f150", "f090", "f150", "f090"]),
            "base_det_index": np.array([1, 0, 0, 1]),
            "xi": np.array([0.1, -0.2, 0.3, 0.4])}
    return Table(cols), pd.DataFrame(cols)


OPS = {
    "sort_values": lambda t: t.sort_values(["band_name", "base_det_index"], ignore_index=True),
    "iloc": lambda t: t.iloc[[2, 0]],
    "loc_mask": lambda t: t.loc[np.array([True, False, True, True])],
    "take": lambda t: t.take([3, 3, 1]),
    "concat": lambda t: (concat([t, t]) if isinstance(t, Table)
                         else pd.concat([t, t], ignore_index=True)),
    "reset_index_copy": lambda t: t.copy().reset_index(drop=True),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_table_matches_dataframe(op):
    table, frame = _pair()
    got, want = OPS[op](table), OPS[op](frame)
    assert got.columns == list(want.columns)
    for col in got.columns:
        np.testing.assert_array_equal(got[col], want[col].values)
        np.testing.assert_array_equal(getattr(got, col), want[col].values)


def test_table_columns_broadcast_insert_and_rows():
    table, frame = _pair()
    table["pol_label"] = "A"
    frame["pol_label"] = "A"
    table.insert(0, "h", np.arange(4.0))
    frame.insert(0, "h", np.arange(4.0))
    assert table.columns == list(frame.columns)
    rows = [(i, r.xi, r.pol_label) for i, r in table.iterrows()]
    assert rows == [(i, r.xi, r.pol_label) for i, r in frame.iterrows()]
    with pytest.raises(ValueError):
        table["bad"] = np.arange(3)


def test_table_csv_and_json_round_trip(tmp_path):
    path = tmp_path / "pads.csv"
    path.write_text("baseline_x,name,n\n1.5,a,3\n-2.0,b,4\n")
    table, frame = read_csv(str(path)), pd.read_csv(path)
    for col in frame.columns:
        np.testing.assert_array_equal(table[col], frame[col].values)
    assert table.n.dtype.kind == "i" and table.name.dtype.kind == "U"
    back = Table.from_json(table.to_json())
    for col in table.columns:
        np.testing.assert_array_equal(back[col], table[col])


def test_json_registries_read_like_yaml(tmp_path):
    """Every packaged registry is JSON; the same content written as YAML
    reads back identically through the user-config reader."""
    import glob
    import os

    yaml = pytest.importorskip("yaml")
    import maria_tpu
    from maria_tpu.io import read_json, read_yaml

    root = os.path.dirname(maria_tpu.__file__)
    paths = sorted(glob.glob(f"{root}/*/configs/*.json"))
    assert len(paths) == 28
    assert not glob.glob(f"{root}/**/*.yml", recursive=True)
    for path in paths:
        data = read_json(path)
        as_yaml = tmp_path / "config.yml"
        as_yaml.write_text(yaml.safe_dump(data))
        assert read_yaml(str(as_yaml)) == data == json.load(open(path))
    assert maria_tpu.get_instrument("MUSTANG-2").dets.n == 217
    assert "daisy_5arcmin_60s" in maria_tpu.all_plans

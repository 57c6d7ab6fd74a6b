"""chip_smoke.py's phases at tiny sizes on the CPU device.

The script itself refuses to run without a GPU; its phase functions take
the device to use, so the same code runs here with the CPU standing in
for the card (and as its own CPU oracle).
"""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from svgrasterize_tpu.text.fonts import DEFAULT_FONTS, FontsDB
from svgrasterize_tpu.utils.stress import filter_doc, stress_doc, text_doc

TINY = {
    "stress": {"n_items": 30, "size": 96},
    "stress_3840": {"n_items": 60, "size": 160},
    "filter": {"n_groups": 4, "width": 160, "height": 64},
    "icons": 6,
    "icon_size": 24,
    "atlas_cell": 32,
    "tiles": (32, 64),
    "frames": 1,
    "many": 2,
}


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_main_refuses_to_run_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


@pytest.mark.parametrize(
    "name,svg",
    [
        ("stress", stress_doc(**TINY["stress"])),
        ("filter", filter_doc(**TINY["filter"])),
    ],
)
def test_serve_phase_tiny(name, svg, cpu):
    out = cs.serve_phase(name, svg, cpu, cpu, frames=1, many=2)
    assert out["deterministic"]
    assert out["warm_ms"] > 0 and out["compile_s"] == out["compile_s"]
    for key in ("vs_cpu", "vs_interp", "many_vs_render"):
        diff, tol = (float(x) for x in out[key].split("<="))
        assert diff <= tol


def test_serve_phase_flags_a_wrong_oracle(cpu, monkeypatch):
    """A tolerance the output cannot meet must fail the phase."""
    monkeypatch.setattr(cs, "TOL_INTERP_CLIP", -1.0)
    with pytest.raises(cs.SmokeError):
        cs.serve_phase("stress", stress_doc(**TINY["stress"]), cpu, cpu,
                       frames=1, many=2, cpu_oracle=False)


def test_cli_phase_tiny(cpu, tmp_path):
    fonts = FontsDB()
    fonts.register_file(DEFAULT_FONTS)
    for name, svg, clip in (
        ("stress", stress_doc(**TINY["stress"]), True),
        ("text", text_doc(width=240, height=40, font_size=16), False),
    ):
        out = cs.cli_phase(name, svg, str(tmp_path), cpu, cpu, fonts, clip)
        assert out["cold_s"] > 0 and out["warm_s"] > 0
        assert "<=" in out["vs_cpu"] and "<=" in out["vs_interp"]


def test_tiles_phase_tiny(cpu):
    rows = cs.tiles_phase(stress_doc(**TINY["stress"]), cpu, TINY["tiles"], 1)
    assert sorted(rows) == sorted(TINY["tiles"])
    assert "vs_first_tile" in rows[TINY["tiles"][1]]


def test_four_phase_on_virtual_devices():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    res = cs.four_phase(TINY, devices)
    assert set(res) >= {"stress", "stress_3840", "atlas"}
    assert res["atlas"]["docs"] == TINY["icons"]
    assert len(res["peak_bytes_per_device"]) == 4


def test_host_plan_strips_device_caches(cpu):
    import svgrasterize_tpu.render_plan as rp

    scene, viewport = cs._scene(filter_doc(**TINY["filter"]))
    compiled = rp.compile_scene(scene, cs.TR, viewport, False)
    first = np.asarray(compiled.render().image)
    plan = cs.host_plan(compiled._lowered)
    assert not any(k.startswith("_") for k in plan.items)
    for g in plan.groups:
        assert "_post_program" not in g
        assert not any(k.startswith("_") for k in g["items"])
    again = np.asarray(rp.CompiledScene(plan, viewport, False).render().image)
    np.testing.assert_array_equal(first, again)


def test_card_line_never_raises():
    assert cs.card_line().startswith("card: ")

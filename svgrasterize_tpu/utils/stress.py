"""Seeded scene generators: documents the repo builds itself, so every
run (tests, the GPU smoke run, benchmarks) needs no downloaded assets.

`stress_doc` is the anti-collapse worst case: thousands of SMALL
overlapping items with an opacity GROUP interleaved after every
gradient shape — group outputs are frame-dynamic pool reads (tex
items), which are the only paints the static-run collapse can never
precompose (solid AND gradient runs both collapse), so runs break at
every other item and every item survives to the executor; the pass mix
per tile stays deep.

`filter_doc` is a filter-heavy icon sheet (opacity groups under
feGaussianBlur / feDropShadow), `icon_doc` a small icon for atlas
batches, and `text_doc` a line of text in the bundled SVG fonts.

All are deterministic in their arguments, so recorded numbers are
comparable across runs.
"""

from __future__ import annotations


def stress_doc(n_items: int = 2000, size: int = 1024, seed: int = 0) -> str:
    """A worst-case SVG document of n_items small overlapping draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    defs = []
    for g in range(8):
        stops = "".join(
            f'<stop offset="{o:.2f}" stop-color="rgb({rng.integers(0, 256)},'
            f'{rng.integers(0, 256)},{rng.integers(0, 256)})" '
            f'stop-opacity="{rng.uniform(0.4, 1):.2f}"/>'
            for o in (0.0, float(rng.uniform(0.3, 0.7)), 1.0)
        )
        if g % 2:
            defs.append(
                f'<linearGradient id="g{g}" x1="0" y1="0" '
                f'x2="{rng.uniform(0.5, 1):.2f}" y2="1">{stops}'
                "</linearGradient>"
            )
        else:
            defs.append(
                f'<radialGradient id="g{g}" fx="{rng.uniform(0.2, 0.4):.2f}" '
                f'fy="{rng.uniform(0.2, 0.4):.2f}">{stops}</radialGradient>'
            )
    for c in range(6):
        cx, cy = rng.integers(0, size, 2)
        defs.append(
            f'<clipPath id="c{c}"><circle cx="{cx}" cy="{cy}" '
            f'r="{rng.integers(size // 4, size // 2)}"/></clipPath>'
        )

    body = []
    i = 0
    while i < n_items:
        x, y = rng.integers(0, size - 40, 2)
        paint = f"url(#g{i % 8})"
        attrs = f'fill="{paint}" fill-opacity="{rng.uniform(0.3, 0.9):.2f}"'
        if i % 3 == 0:
            attrs += f' clip-path="url(#c{i % 6})"'
        if i % 5 == 0:
            attrs += (
                f' transform="rotate({rng.uniform(-30, 30):.1f} {x} {y})"'
            )
        kind = (i // 2) % 3 if i % 2 == 0 else 3
        if kind == 0:
            shape = (
                f'<rect x="{x}" y="{y}" width="{rng.integers(12, 40)}" '
                f'height="{rng.integers(12, 40)}" {attrs}/>'
            )
        elif kind == 1:
            shape = (
                f'<circle cx="{x}" cy="{y}" r="{rng.integers(6, 22)}" '
                f"{attrs}/>"
            )
        elif kind == 2:
            x2, y2 = x + rng.integers(10, 40), y + rng.integers(10, 40)
            shape = (
                f'<path d="M{x} {y} Q{x2} {y} {x2} {y2} T{x} {y2} Z" '
                f"{attrs}/>"
            )
        else:
            # opacity group with two members: an isolation pass whose
            # output is a frame-dynamic tex item — breaks every run
            shape = (
                f'<g opacity="{rng.uniform(0.3, 0.8):.2f}">'
                f'<rect x="{x}" y="{y}" width="24" height="24" {attrs}/>'
                f'<circle cx="{x + 14}" cy="{y + 14}" r="10" '
                f'fill="url(#g{(i + 1) % 8})"/></g>'
            )
            i += 1  # the group emits two draws
        body.append(shape)
        i += 1

    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}"><defs>{"".join(defs)}</defs>{"".join(body)}</svg>'
    )


def filter_doc(
    n_groups: int = 32, width: int = 1114, height: int = 286, seed: int = 0
) -> str:
    """A filter-heavy icon sheet: n_groups opacity groups on a grid, every
    group filtered by one of four feGaussianBlur or four feDropShadow
    filters, with a crisp unfiltered outline over each icon.  The shape
    of an icon-set preview page: each group is one isolation pass plus a
    filter post-op, so the plan has one blur part per group."""
    import numpy as np

    rng = np.random.default_rng(seed)
    defs = []
    for f in range(4):
        defs.append(
            f'<filter id="b{f}"><feGaussianBlur '
            f'stdDeviation="{rng.uniform(0.8, 3.0):.2f}"/></filter>'
        )
        defs.append(
            f'<filter id="d{f}"><feDropShadow dx="{rng.uniform(1, 3):.1f}" '
            f'dy="{rng.uniform(1, 3):.1f}" '
            f'stdDeviation="{rng.uniform(0.8, 2.0):.2f}" '
            'flood-color="#000" flood-opacity="0.5"/></filter>'
        )
    for g in range(4):
        defs.append(
            f'<linearGradient id="g{g}" x1="0" y1="0" x2="1" y2="1">'
            f'<stop offset="0" stop-color="rgb({rng.integers(0, 256)},'
            f'{rng.integers(0, 256)},{rng.integers(0, 256)})"/>'
            f'<stop offset="1" stop-color="rgb({rng.integers(0, 256)},'
            f'{rng.integers(0, 256)},{rng.integers(0, 256)})"/>'
            "</linearGradient>"
        )

    cols = max(1, -(-n_groups // 2))
    rows = -(-n_groups // cols)
    cw, ch = width / cols, height / rows
    body = []
    for i in range(n_groups):
        x0, y0 = (i % cols) * cw, (i // cols) * ch
        cx, cy = x0 + cw / 2, y0 + ch / 2
        r = 0.32 * min(cw, ch)
        flt = f"{'bd'[i % 2]}{(i // 2) % 4}"
        color = (
            f"rgb({rng.integers(0, 256)},{rng.integers(0, 256)},"
            f"{rng.integers(0, 256)})"
        )
        body.append(
            f'<g opacity="{rng.uniform(0.5, 0.95):.2f}" filter="url(#{flt})">'
            f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="{r:.1f}" '
            f'fill="url(#g{i % 4})"/>'
            f'<rect x="{cx - r / 2:.1f}" y="{cy - r / 2:.1f}" '
            f'width="{r:.1f}" height="{r:.1f}" fill="{color}" '
            f'transform="rotate({rng.uniform(0, 90):.1f} {cx:.1f} {cy:.1f})"/>'
            "</g>"
            f'<path d="M{cx - r:.1f} {cy:.1f} Q{cx:.1f} {cy - 1.4 * r:.1f} '
            f'{cx + r:.1f} {cy:.1f}" fill="none" stroke="#202020" '
            'stroke-width="1.5"/>'
        )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}"><defs>{"".join(defs)}</defs>{"".join(body)}</svg>'
    )


def icon_doc(seed: int, size: int = 48) -> str:
    """A small icon: a gradient badge, a few solid shapes and a stroke,
    different for every seed (distinct documents for atlas batches)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rgb():
        return (
            f"rgb({rng.integers(0, 256)},{rng.integers(0, 256)},"
            f"{rng.integers(0, 256)})"
        )

    c = size / 2
    parts = [
        f'<defs><radialGradient id="r" fx="{rng.uniform(0.2, 0.5):.2f}" '
        f'fy="{rng.uniform(0.2, 0.5):.2f}"><stop offset="0" '
        f'stop-color="{rgb()}"/><stop offset="1" stop-color="{rgb()}"/>'
        "</radialGradient></defs>",
        f'<circle cx="{c}" cy="{c}" r="{0.45 * size:.1f}" fill="url(#r)"/>',
    ]
    for _ in range(int(rng.integers(2, 5))):
        x, y = rng.uniform(0.15, 0.6, 2) * size
        w, h = rng.uniform(0.15, 0.35, 2) * size
        parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" height="{h:.1f}" '
            f'rx="{0.2 * w:.1f}" fill="{rgb()}" '
            f'fill-opacity="{rng.uniform(0.6, 1):.2f}"/>'
        )
    a, b = rng.uniform(0.2, 0.8, 2) * size
    parts.append(
        f'<path d="M{0.2 * size:.1f} {a:.1f} L{c:.1f} {b:.1f} '
        f'L{0.8 * size:.1f} {a:.1f}" fill="none" stroke="{rgb()}" '
        f'stroke-width="{rng.uniform(1, 3):.1f}" stroke-linecap="round"/>'
    )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}">{"".join(parts)}</svg>'
    )


def text_doc(
    text: str = "The quick brown fox jumps over the lazy dog, 0123456789",
    width: int = 960, height: int = 64, font_size: float = 28.0,
) -> str:
    """One line of text set in the bundled SVG fonts (sans, serif, mono)."""
    y = 0.68 * height
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}"><rect width="{width}" height="{height}" '
        f'fill="#fafafa"/><text x="8" y="{y:.0f}" font-size="{font_size}" '
        f'font-family="Source Sans Pro" fill="#202040">{text} '
        '<tspan font-family="Source Code Pro" fill="#a03020">x => y</tspan>'
        "</text></svg>"
    )

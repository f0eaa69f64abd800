"""Fixed SVG-Bench-style probe set for the real-checkpoint parity harness
(the port's copy of starvector_tpu/validation/parity_samples.py).

Eight small hand-written SVGs spanning the benchmark's structural modes
(reference README.md:156-189 — icons: compact paths; emoji: filled shapes
with palettes; fonts: single glyph-like path; diagrams: strokes + text
layout). Committed in-repo so the parity artifact is reproducible without
any dataset download."""

SAMPLES: list[tuple[str, str]] = [
    (
        "icon-check",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 24 24">'
        '<path d="M9 16.17 4.83 12l-1.42 1.41L9 19 21 7l-1.41-1.41z"/></svg>',
    ),
    (
        "icon-gear",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 24 24">'
        '<path d="M12 8a4 4 0 1 0 0 8 4 4 0 0 0 0-8zm9 4a7 7 0 0 0-.1-1.2'
        'l2-1.6-2-3.4-2.4 1a7 7 0 0 0-2-1.2L16 3h-4l-.4 2.6a7 7 0 0 0-2 '
        '1.2l-2.4-1-2 3.4 2 1.6A7 7 0 0 0 7 12a7 7 0 0 0 .1 1.2l-2 1.6 2 '
        '3.4 2.4-1a7 7 0 0 0 2 1.2L12 21h4l.4-2.6a7 7 0 0 0 2-1.2l2.4 1 '
        '2-3.4-2-1.6A7 7 0 0 0 21 12z"/></svg>',
    ),
    (
        "emoji-sun",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 36 36">'
        '<circle cx="18" cy="18" r="8" fill="#FFAC33"/>'
        '<path d="M18 2v5M18 29v5M2 18h5M29 18h5M6 6l4 4M26 26l4 4M30 6l-4 '
        '4M10 26l-4 4" stroke="#FFAC33" stroke-width="3" '
        'stroke-linecap="round"/></svg>',
    ),
    (
        "emoji-heart",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 36 36">'
        '<path fill="#DD2E44" d="M35.885 11.833c0-5.45-4.418-9.868-9.867'
        '-9.868-3.308 0-6.227 1.633-8.018 4.129-1.791-2.496-4.71-4.129'
        '-8.017-4.129-5.45 0-9.868 4.417-9.868 9.868 0 .772.098 1.52.266 '
        '2.241C1.751 22.587 11.216 31.568 18 34.034c6.783-2.466 16.249'
        '-11.447 17.617-19.959.17-.721.268-1.469.268-2.242z"/></svg>',
    ),
    (
        "font-glyph-a",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 100 100">'
        '<path d="M50 15 25 85h12l5-16h16l5 16h12L50 15zm-4 44 4-14 4 14'
        'h-8z"/></svg>',
    ),
    (
        "shapes-rect-circle",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 64 64">'
        '<rect x="6" y="6" width="28" height="28" rx="4" fill="#4285F4"/>'
        '<circle cx="44" cy="44" r="14" fill="#EA4335"/>'
        '<path d="M6 58h52" stroke="#34A853" stroke-width="4"/></svg>',
    ),
    (
        "diagram-flow",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 120 60">'
        '<rect x="4" y="20" width="30" height="20" fill="none" '
        'stroke="#333" stroke-width="2"/>'
        '<rect x="86" y="20" width="30" height="20" fill="none" '
        'stroke="#333" stroke-width="2"/>'
        '<path d="M34 30h48m-8-6 8 6-8 6" fill="none" stroke="#333" '
        'stroke-width="2"/></svg>',
    ),
    (
        "gradient-badge",
        '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 48 48">'
        '<defs><linearGradient id="g" x1="0" y1="0" x2="1" y2="1">'
        '<stop offset="0" stop-color="#8E24AA"/>'
        '<stop offset="1" stop-color="#3949AB"/></linearGradient></defs>'
        '<circle cx="24" cy="24" r="20" fill="url(#g)"/>'
        '<path d="M24 12l3.5 7.1 7.8 1.1-5.6 5.5 1.3 7.8-7-3.7-7 3.7 '
        '1.3-7.8-5.6-5.5 7.8-1.1z" fill="#fff"/></svg>',
    ),
]

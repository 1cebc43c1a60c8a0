"""Channel wavelength -> display color mapping.

Parity with reference stitcher.py:282-296 (`get_channel_color`) and the GUI
map (stitcher_gui.py:11-20).
"""

from __future__ import annotations

CHANNEL_COLOR_MAP = {
    '405': 0x0000FF,  # Blue
    '488': 0x00FF00,  # Green
    '561': 0xFFCF00,  # Yellow
    '638': 0xFF0000,  # Red
    '730': 0x770000,  # Dark red
    '_B': 0x0000FF,   # Blue
    '_G': 0x00FF00,   # Green
    '_R': 0xFF0000,   # Red
}

DEFAULT_CHANNEL_COLOR = 0xFFFFFF  # White


def get_channel_color(channel_name: str) -> int:
    """Return the 24-bit display color for a channel name.

    First matching substring in insertion order wins, default white —
    identical lookup semantics to reference stitcher.py:293-296.
    """
    for key, color in CHANNEL_COLOR_MAP.items():
        if key in channel_name:
            return color
    return DEFAULT_CHANNEL_COLOR

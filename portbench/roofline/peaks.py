"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet of the H100 SXM: dense rates, at its full 700 W power limit).  A
roofline share is stated against these, with the card's power limit
beside it."""

PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12,
             "tf32_flop_per_s": 495e12, "bf16_flop_per_s": 989e12},
}


def peaks_of(device_name: str) -> dict | None:
    """The peaks of a card by its name, or None for a card not listed."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None

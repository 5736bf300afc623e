"""Published peaks of the cards the benchmark may run on, by the name
``torch.cuda.get_device_name()`` gives.  A roofline share is reported
only on a card listed here.

NVIDIA H100 SXM data sheet, dense rates: HBM3 at 3.35 TB/s (at the
full 700 W power limit).
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(card: str, key: str) -> "float | None":
    return PEAKS.get(card, {}).get(key)

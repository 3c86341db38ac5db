"""Published peaks of the cards a run may report (data sheets, dense rates)."""

# NVIDIA H100 SXM5 80 GB: HBM3 bandwidth in bytes/s, at its 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str):
    """The card's published memory bandwidth, or None for a card not listed."""
    return HBM_BYTES_PER_S.get(kind)

"""Load the calibration artifact into live model objects.

``calibrated.json`` beside this module is the port's own copy of the
reference's artifact (a test holds the two byte-identical).
"""
from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache
from typing import Any, Dict

from .aging import AgingParams
from .avs import LifetimeConfig
from .ber import BerModel
from .delay import DelayPolynomial
from .power import PowerModel

CAL_PATH = os.path.join(os.path.dirname(__file__), "calibrated.json")


@dataclasses.dataclass(frozen=True)
class Calibration:
    aging: AgingParams
    delay_poly: DelayPolynomial
    ber: BerModel
    power: PowerModel
    lifetime_cfg: LifetimeConfig
    raw: Dict[str, Any]


@lru_cache(maxsize=1)
def load_calibration(path: str = CAL_PATH) -> Calibration:
    with open(path) as f:
        blob = json.load(f)
    return Calibration(
        aging=AgingParams.from_dict(blob["aging"]),
        delay_poly=DelayPolynomial.from_dict(blob["delay_poly"]),
        ber=BerModel.from_dict(blob["ber"]),
        power=PowerModel.from_dict(blob["power"]),
        lifetime_cfg=LifetimeConfig(**blob["lifetime_cfg"]),
        raw=blob,
    )

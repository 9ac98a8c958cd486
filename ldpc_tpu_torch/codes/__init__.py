"""QC code structures, the JSON code format, CCSDS near-earth, the IEEE
802.11n codes and synthetic QC codes."""

from .ccsds import near_earth_code
from .io import code_from_dict, code_to_dict, load_code_json, save_code_json
from .qc import QCCode
from .synthetic import synthetic_qc_code
from .wifi import wifi_code, wifi_rates

__all__ = ["QCCode", "near_earth_code", "wifi_code", "wifi_rates",
           "code_from_dict", "code_to_dict", "load_code_json",
           "save_code_json", "synthetic_qc_code"]

"""QC code structures, the JSON code format and the CCSDS near-earth code."""

from .ccsds import near_earth_code
from .io import code_from_dict, code_to_dict, load_code_json, save_code_json
from .qc import QCCode

__all__ = ["QCCode", "near_earth_code", "code_from_dict", "code_to_dict",
           "load_code_json", "save_code_json"]

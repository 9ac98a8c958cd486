"""QC code structures, the JSON code format and the reference's file
formats, the observation codec, CCSDS near-earth and its generator, the
IEEE 802.11n codes, synthetic QC codes, the zeroed-circulant suite and the
systematic encoder."""

from .ccsds import (near_earth_code, near_earth_generator_dense,
                    near_earth_generator_rows)
from .codec import compress, observation_bytes, uncompress
from .encode import (encode, encoder_for_code, make_encoder,
                     parity_part_from_h, systematic_encoder_from_h)
from .io import (bits_to_hex, code_from_dict, code_hex_name, code_to_dict,
                 hex_to_bits, load_code_instance, load_code_json,
                 read_dense_generator, read_qc_generator_rows,
                 read_qc_parity, save_code_instance, save_code_json)
from .perturb import write_suite, zero_circulant, zeroed_circulant_suite
from .qc import QCCode, edges_by_block_col, edges_by_block_row
from .synthetic import synthetic_qc_code
from .wifi import (WIFI_1944_81_RATE_1_2, WIFI_1944_81_RATE_2_3,
                   WIFI_1944_81_RATE_3_4, WIFI_1944_81_RATE_5_6,
                   from_prototype, wifi_code, wifi_rates)

__all__ = ["QCCode", "edges_by_block_col", "edges_by_block_row",
           "near_earth_code", "wifi_code", "wifi_rates",
           "WIFI_1944_81_RATE_1_2", "WIFI_1944_81_RATE_2_3",
           "WIFI_1944_81_RATE_3_4", "WIFI_1944_81_RATE_5_6",
           "from_prototype",
           "code_from_dict", "code_to_dict", "load_code_json",
           "save_code_json", "synthetic_qc_code", "compress", "uncompress",
           "observation_bytes", "hex_to_bits", "bits_to_hex",
           "code_hex_name", "read_qc_parity", "read_qc_generator_rows",
           "read_dense_generator", "save_code_instance",
           "load_code_instance", "zero_circulant", "zeroed_circulant_suite",
           "write_suite", "near_earth_generator_rows",
           "near_earth_generator_dense", "encode", "encoder_for_code",
           "make_encoder", "parity_part_from_h", "systematic_encoder_from_h"]

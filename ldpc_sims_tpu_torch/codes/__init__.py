"""LDPC code library: code definitions, GF(2) algebra, Tanner compiler."""

from ldpc_sims_tpu_torch.codes.library import (  # noqa: F401
    LdpcCode,
    QcStructure,
    get_code,
    list_codes,
    make_regular_ldpc,
    reference_6432,
)
from ldpc_sims_tpu_torch.codes.tanner import TannerGraph  # noqa: F401
from ldpc_sims_tpu_torch.codes.alist import load_alist, save_alist  # noqa: F401
from ldpc_sims_tpu_torch.codes.wifi import wifi_80211n  # noqa: F401

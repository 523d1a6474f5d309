from .bgzf import BgzfReader, BgzfWriter, is_bgzf, make_voffset, split_voffset
from .mtx import (
    peek_mtx_header,
    visit_mtx_triplets,
    read_mtx_block,
    MtxHeader,
)
from .index import build_mmutil_index, read_mmutil_index, check_index_tab
from .writers import (
    write_data_file,
    write_vector_file,
    write_matrix_market_file,
    read_data_file,
    read_vector_file,
    read_pair_file,
)

from .formats import (
    CSR5Matrix,
    CSRMatrix,
    col_tiles_of,
    csr5_from_numpy,
    csr5_to_numpy,
    csr_from_numpy,
    csr_from_scipy,
)

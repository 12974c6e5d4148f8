"""The paper's own experiment config: FD + R-MAT sweeps on Sandy Bridge."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SpMVExperimentConfig:
    min_log2_rows: int = 11
    max_log2_rows: int = 26
    thread_counts: tuple = (1, 2, 4, 8, 16)
    fd_nnz_per_row: int = 9
    rmat_nnz_per_row: int = 8
    constant_work: int = 2 ** 33     # runs = 2^33 / nnz (paper §III-A)


CONFIG = SpMVExperimentConfig()

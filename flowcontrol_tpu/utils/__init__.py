"""Utility layer (ref: src/utils/__init__.py).

``flowcontrol_tpu.utils`` doubles as the legacy flat aggregator namespace the
reference calls ``flu`` (ref: src/utils/utils_flowsolver.py:1-133): the most
used symbols from fem/io/linalg/lticontrol/optim/signal are re-exported here
so ``import flowcontrol_tpu.utils as flu`` works for reference-style code.
"""

from flowcontrol_tpu.utils.fem import (  # noqa: F401
    apply_fun,
    get_subspace_dofs,
    print0,
    projectm,
    summarize_timings,
)
from flowcontrol_tpu.utils.io import (  # noqa: F401
    export_boundary_field,
    export_complex_field,
    export_dof_map,
    export_field_vtk,
    export_npz_to_mat,
    export_sparse_matrix,
    export_square_operators,
    load_Hw,
    plot_Hw,
    save_Hw,
)
from flowcontrol_tpu.utils.linalg import (  # noqa: F401
    dense_to_sparse,
    eigenproblem_slepc,
    get_field_response,
    get_frequency_response,
    get_frequency_response_mpi,
    get_frequency_response_parallel,
    get_frequency_response_sequential,
    get_frequency_response_device,
    get_mat_vp_shift_invert,
    get_mat_vp_slepc,
    sparse_to_coo_triplets,
)
from flowcontrol_tpu.utils.lticontrol import *  # noqa: F401,F403
from flowcontrol_tpu.utils.optim import (  # noqa: F401
    batch_evaluate,
    parallel_function_wrapper,
    compute_control_cost,
    compute_signal_cost,
    cummin,
    fun_array,
    sobol_sample,
    write_optim_csv,
    write_results,
)
from flowcontrol_tpu.utils.signal import (  # noqa: F401
    MultisineGenerator,
    plotsignal,
    MyEncoder,
    NoIndent,
    compute_signal_frequency,
    crest_factor,
    multisine,
    multisine_MP,
    pad_upto,
    sample_lco,
    saturate,
)

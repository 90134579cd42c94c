from apdmvs_tpu_torch.io.formats import (  # noqa: F401
    read_bin_mat,
    write_bin_mat,
    read_camera,
    write_camera,
    read_pair_file,
    write_pair_file,
    export_point_cloud,
    read_point_cloud,
    to_format_index,
)

from .headers import (
    nal_write,
    write_parameter_sets,
    write_picture_header,
    write_pps,
    write_slice_header,
    write_sps,
)

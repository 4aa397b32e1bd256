from .flow_io import flow_to_image, read_flo, write_flo  # noqa: F401
from .frame_io import read_gen  # noqa: F401

"""Data pipeline: flow and frame I/O, dataset indices, the loader and its
prefetch onto the device."""

from .flow_io import flow_to_image, read_flo, write_flo  # noqa: F401
from .frame_io import read_gen  # noqa: F401
from .datasets import (  # noqa: F401
    DATASETS,
    ChairsSDHom,
    ChairsSDHomTest,
    ChairsSDHomTrain,
    FlowDataset,
    FlyingChairs,
    FlyingThings,
    FlyingThingsClean,
    FlyingThingsFinal,
    ImagesFromFolder,
    MpiSintel,
    MpiSintelClean,
    MpiSintelFinal,
    StaticCenterCrop,
    StaticRandomCrop,
    get_dataset,
)
from .loader import (  # noqa: F401
    Batch,
    DataLoader,
    DeviceLoader,
    device_prefetch,
)

from repro_torch.data.pipeline import (DeviceDataset, make_fleet_datasets,
                                       synthetic_lm_task, batch_specs)  # noqa: F401

from repro_torch.data.pipeline import (ArithGenerator, CopyGenerator,
                                       DataConfig, MarkovGenerator,
                                       data_iterator, make_generator)

__all__ = ["DataConfig", "MarkovGenerator", "ArithGenerator", "CopyGenerator",
           "data_iterator", "make_generator"]

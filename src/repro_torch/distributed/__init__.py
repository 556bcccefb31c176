from repro_torch.distributed.sharding import MeshShape, ShardingPolicy

__all__ = ["MeshShape", "ShardingPolicy"]

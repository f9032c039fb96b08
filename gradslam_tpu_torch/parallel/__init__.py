from . import multihost
from .mesh import Mesh, make_mesh, shard_batch, shard_map_state, unshard_batch, unshard_map_state
from .multihost import host_summary, initialize_multihost, is_multihost
from .pipeline import pipeline_mesh, pipelined_slam_sequence
from .pose_refine import (
    PoseGraph,
    ba_refine,
    ba_refine_sharded,
    partition_observations_by_landmark,
    pose_graph_refine,
    pose_graph_refine_sharded,
    pose_graph_residuals,
)
from .seqpar import SeqParResult, chunk_sequence, merge_chunk_maps, sequence_parallel_slam
from .sharded import (
    DepthCalibParams,
    depth_calib_from_numpy,
    sharded_slam,
    sharded_train_step,
    slam_loss,
)

__all__ = [
    "multihost",
    "initialize_multihost",
    "is_multihost",
    "host_summary",
    "Mesh",
    "make_mesh",
    "shard_batch",
    "shard_map_state",
    "unshard_batch",
    "unshard_map_state",
    "pipeline_mesh",
    "pipelined_slam_sequence",
    "PoseGraph",
    "pose_graph_residuals",
    "pose_graph_refine",
    "pose_graph_refine_sharded",
    "ba_refine",
    "ba_refine_sharded",
    "partition_observations_by_landmark",
    "SeqParResult",
    "chunk_sequence",
    "sequence_parallel_slam",
    "merge_chunk_maps",
    "DepthCalibParams",
    "slam_loss",
    "depth_calib_from_numpy",
    "sharded_slam",
    "sharded_train_step",
]

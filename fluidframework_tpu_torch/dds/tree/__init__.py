"""SharedTree: the hierarchical DDS, host half and channel.

The port's own copy of ``fluidframework_tpu/dds/tree`` (no JAX in it).
Reference parity: packages/dds/tree (SharedTreeKernel sharedTree.ts:176,
SharedTreeCore sharedTreeCore.ts:92, EditManager editManager.ts:73, the
ChangeRebaser contract changeRebaser.ts:41, modular change family under
feature-libraries/, chunked forest uniformChunk.ts:42, simple-tree typed
API).

- ``forest``       — object forest (host) + columnar uniform chunks (the
                     device-friendly value representation).
- ``changeset``    — one uniform mark-based changeset algebra (sequence
                     fields subsume value/optional fields); pure functions
                     rebase/invert/apply with enrichment for repair data.
- ``field_kinds``, ``mark_pool`` — the field-kind rebasers and the pooled
                     columnar fold the tree fleet engine runs.
- ``editmanager``  — trunk + simulated per-peer branches; deterministic
                     trunk construction gives convergence by construction.
- ``schema``       — stored schema + typed view layer; ``simple_tree`` the
                     class-based view, ``branch`` forks, and
                     ``reference_summary`` the reference's summary format.
- ``shared_tree``  — the channel-boundary DDS wiring it all together.

The device half (the tree fleet programs and the flat forest, K7/K8/K11)
lives in ``fluidframework_tpu_torch.ops.tree_kernel``.
"""


from .changeset import (
    Insert,
    Mark,
    Modify,
    NodeChange,
    Remove,
    Skip,
    apply_node_change,
    change_from_json,
    change_to_json,
    invert_node_change,
    rebase_node_change,
)
from .branch import TreeBranch
from .editmanager import EditManager, TrunkCommit
from .forest import Forest, Node, UniformChunk
from .schema import (
    FieldKind,
    FieldSchema,
    LeafKind,
    NodeSchema,
    SchemaCompatibility,
    SchemaRegistry,
    SchemaView,
    TreeView,
    schema_compat,
)
from .shared_tree import SharedTreeChannel, SharedTreeFactory

from .simple_tree import (
    SchemaFactory,
    SimpleTreeView,
    Tree,
    TreeArrayNode,
    TreeNodeSchema,
    TreeObjectNode,
    TreeViewConfiguration,
    optional,
    required,
)

__all__ = [
    "EditManager",
    "SchemaFactory",
    "SimpleTreeView",
    "Tree",
    "TreeArrayNode",
    "TreeNodeSchema",
    "TreeObjectNode",
    "TreeViewConfiguration",
    "optional",
    "required",
    "SchemaCompatibility",
    "SchemaView",
    "TreeBranch",
    "schema_compat",
    "FieldKind",
    "FieldSchema",
    "Forest",
    "Insert",
    "LeafKind",
    "Mark",
    "Modify",
    "Node",
    "NodeChange",
    "NodeSchema",
    "Remove",
    "SchemaRegistry",
    "SharedTreeChannel",
    "SharedTreeFactory",
    "Skip",
    "TreeView",
    "TrunkCommit",
    "UniformChunk",
    "apply_node_change",
    "change_from_json",
    "change_to_json",
    "invert_node_change",
    "rebase_node_change",
]

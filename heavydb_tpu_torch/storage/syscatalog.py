"""System catalog: users, roles, object privileges.

Reference: Catalog_Namespace::SysCatalog (Catalog/SysCatalog.h:180) with its
grantee graph (Grantee.cpp) and DBObject privileges — rebuilt compactly:
users and roles are grantees; privileges attach to (grantee, object) where
object is a table name or '*' (database-wide); role membership is
transitive through the grantee graph.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from heavydb_tpu_torch.errors import CatalogError, HeavyTpuError


class PermissionError_(HeavyTpuError):
    pass


PRIVILEGES = {"SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALL"}

_STMT_PRIV = {
    "Select": "SELECT",
    "InsertValues": "INSERT",
    "InsertSelect": "INSERT",
    "Update": "UPDATE",
    "Delete": "DELETE",
    "CopyFrom": "INSERT",
    "CreateTable": "CREATE",
    "DropTable": "DROP",
    "TruncateTable": "DELETE",
}


def _hash(password: str, salt: str) -> str:
    return hashlib.sha256((salt + password).encode()).hexdigest()


@dataclass
class User:
    name: str
    salt: str
    pw_hash: str
    is_super: bool = False


class SysCatalog:
    def __init__(self):
        self.users: Dict[str, User] = {}
        self.roles: Set[str] = set()
        # grantee -> set of roles granted to it
        self.role_members: Dict[str, Set[str]] = {}
        # (grantee, object) -> set of privileges; object '*' = all tables
        self.grants: Dict[tuple, Set[str]] = {}
        # row-level security: (table, column, grantee) -> tuple of allowed
        # values (reference SqlCreatePolicy + InjectFilterRule — SELECTs
        # by the grantee are filtered to rows where column IN values)
        self.policies: Dict[tuple, tuple] = {}
        self.create_user("admin", "HyperInteractive", is_super=True)

    # ---- users / roles ----
    def create_user(self, name: str, password: str, is_super: bool = False):
        key = name.lower()
        if key in self.users:
            raise CatalogError(f"user {name!r} already exists")
        salt = secrets.token_hex(8)
        self.users[key] = User(name, salt, _hash(password, salt), is_super)

    def drop_user(self, name: str):
        if name.lower() == "admin":
            raise CatalogError("cannot drop admin")
        if self.users.pop(name.lower(), None) is None:
            raise CatalogError(f"user {name!r} does not exist")

    def alter_user(self, name: str, password: Optional[str] = None,
                   is_super: Optional[bool] = None):
        u = self.users.get(name.lower())
        if u is None:
            raise CatalogError(f"user {name!r} does not exist")
        if password is not None:
            u.salt = secrets.token_hex(8)
            u.pw_hash = _hash(password, u.salt)
        if is_super is not None:
            u.is_super = is_super

    def check_login(self, name: str, password: str) -> bool:
        u = self.users.get(name.lower())
        if u is None:
            return False
        return _hash(password, u.salt) == u.pw_hash

    def create_role(self, name: str):
        key = name.lower()
        if key in self.roles or key in self.users:
            raise CatalogError(f"grantee {name!r} already exists")
        self.roles.add(key)

    def drop_role(self, name: str):
        key = name.lower()
        if key not in self.roles:
            raise CatalogError(f"role {name!r} does not exist")
        self.roles.discard(key)
        self.role_members.pop(key, None)
        for members in self.role_members.values():
            members.discard(key)
        for k in [k for k in self.grants if k[0] == key]:
            del self.grants[k]

    def grant_role(self, role: str, grantee: str):
        if role.lower() not in self.roles:
            raise CatalogError(f"role {role!r} does not exist")
        self._check_grantee(grantee)
        self.role_members.setdefault(grantee.lower(), set()).add(role.lower())

    def revoke_role(self, role: str, grantee: str):
        self.role_members.get(grantee.lower(), set()).discard(role.lower())

    def _check_grantee(self, grantee: str):
        key = grantee.lower()
        if key not in self.users and key not in self.roles:
            raise CatalogError(f"grantee {grantee!r} does not exist")

    # ---- object privileges ----
    def grant(self, privs, obj: str, grantee: str):
        self._check_grantee(grantee)
        for p in privs:
            if p not in PRIVILEGES:
                raise CatalogError(f"unknown privilege {p}")
        self.grants.setdefault((grantee.lower(), obj.lower()), set()).update(
            privs
        )

    def revoke(self, privs, obj: str, grantee: str):
        cur = self.grants.get((grantee.lower(), obj.lower()))
        if cur:
            cur.difference_update(privs)

    def _all_grantees_of(self, user: str) -> Set[str]:
        """user + transitively granted roles (grantee graph walk)."""
        out = {user.lower()}
        frontier = [user.lower()]
        while frontier:
            g = frontier.pop()
            for r in self.role_members.get(g, ()):  # roles granted to g
                if r not in out:
                    out.add(r)
                    frontier.append(r)
        return out

    def has_privilege(self, user: str, priv: str, obj: str) -> bool:
        u = self.users.get(user.lower())
        if u is not None and u.is_super:
            return True
        for g in self._all_grantees_of(user):
            for o in (obj.lower(), "*"):
                ps = self.grants.get((g, o), ())
                if priv in ps or "ALL" in ps:
                    return True
        return False

    def check_statement(self, user: str, stmt, tables) -> None:
        """Raise PermissionError_ unless `user` may run `stmt` touching
        `tables` (list of names)."""
        u = self.users.get(user.lower())
        if u is not None and u.is_super:
            return
        priv = _STMT_PRIV.get(type(stmt).__name__)
        if priv is None:
            return  # metadata statements unrestricted for now
        targets = tables or ["*"]
        for t in targets:
            if not self.has_privilege(user, priv, t):
                raise PermissionError_(
                    f"user {user!r} lacks {priv} on {t!r}"
                )

    # ---- persistence ----
    # ---- row-level security policies ----
    def create_policy(self, table: str, column: str, grantee: str, values):
        self._check_grantee(grantee)
        self.policies[(table.lower(), column.lower(), grantee.lower())] = \
            tuple(values)

    def drop_policy(self, table: str, column: str, grantee: str):
        k = (table.lower(), column.lower(), grantee.lower())
        if k not in self.policies:
            raise CatalogError(
                f"no policy on {table}.{column} for {grantee}"
            )
        del self.policies[k]

    def policies_for(self, user: str, table: str):
        """Effective restrictions of `user` on `table`: [(column, values)].
        Superusers are unrestricted; policies granted to any of the user's
        transitive roles apply (reference Catalog::getRestrictions)."""
        u = self.users.get(user.lower())
        if u is not None and u.is_super:
            return []
        grantees = self._all_grantees_of(user)
        t = table.lower()
        out = []
        for (tb, col, g), vals in self.policies.items():
            if tb == t and g in grantees:
                out.append((col, vals))
        return out

    def list_policies(self, grantee: str, effective: bool) -> list:
        gset = (self._all_grantees_of(grantee) if effective
                else {grantee.lower()})
        return sorted(
            (tb, col, g, vals)
            for (tb, col, g), vals in self.policies.items()
            if g in gset
        )

    def list_users(self) -> list:
        return sorted(self.users)

    def list_roles(self) -> list:
        return sorted(self.roles)

    def roles_of(self, user: str) -> Set[str]:
        """Roles transitively granted to a user (reference
        get_all_roles_for_user)."""
        return self._all_grantees_of(user) - {user.lower()}

    def to_json(self) -> dict:
        return {
            "users": [
                {"name": u.name, "salt": u.salt, "hash": u.pw_hash,
                 "super": u.is_super}
                for u in self.users.values()
            ],
            "roles": sorted(self.roles),
            "role_members": {k: sorted(v) for k, v in self.role_members.items()},
            "grants": [
                {"grantee": g, "object": o, "privs": sorted(ps)}
                for (g, o), ps in self.grants.items()
            ],
            "policies": [
                {"table": tb, "column": col, "grantee": g,
                 "values": list(vals)}
                for (tb, col, g), vals in self.policies.items()
            ],
        }

    @classmethod
    def from_json(cls, data: dict) -> "SysCatalog":
        sc = cls.__new__(cls)
        sc.users = {}
        sc.roles = set(data.get("roles", []))
        sc.role_members = {
            k: set(v) for k, v in data.get("role_members", {}).items()
        }
        sc.grants = {}
        for u in data.get("users", []):
            sc.users[u["name"].lower()] = User(
                u["name"], u["salt"], u["hash"], u["super"]
            )
        for g in data.get("grants", []):
            sc.grants[(g["grantee"], g["object"])] = set(g["privs"])
        sc.policies = {
            (p["table"], p["column"], p["grantee"]): tuple(p["values"])
            for p in data.get("policies", [])
        }
        if "admin" not in sc.users:
            sc.create_user("admin", "HyperInteractive", is_super=True)
        return sc
